"""mip-NeRF's LSA cells: the CLI's tuning loop, ``lsa.tune_lsa_scales``, on
mip-NeRF's two-level loss (``render/mipnerf.py``), one network serving both
levels through K-B1's IPE instantiation, in calls of ``steps_per_call``
steps (one CUDA-graph replay a call on the card), on the program's
``RayBatcher`` over the cell's training views.

The run is ``drivers/lsa.py``'s: set-up runs a few calls on a copy of the
network to build the kernels and read the rate of a replayed call; one
``tune_lsa_scales`` call then runs the cell, its first ``1 +
steps_per_call * check_calls`` steps on the benchmark's draws compared, the
window from the batches of the next call to the call's return. The losses
come from the run's ``result.txt``, the optimizer's state after step 1
from ``save_hook``, the scales after the compared steps from the network
when the window's first batches are asked for.

After the window the reference (``reference/mipnerf.py``, in mip-NeRF's
own layer and channel order, the weights as the same flax tree) follows the
compared steps from the same weights, batches (worked out again from the
batcher's seed, each ray's radius measured between neighbouring rows of
its view as the published loader measures it) and draws, in blocks of
``reference_block_rays`` rays. The comparison is ``drivers/lsa.py``'s: the
first step's loss gap, the median step's, the median leaf's gradient gap
and the worst leaf's change gap.
"""
from __future__ import annotations

import math
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from benchmark import harness, scene
from benchmark.counts import kb1_ipe
from benchmark.drivers.lsa import Feed, _leaf_norms_state, window_steps
from benchmark.reference import mipnerf as ref
from benchmark.trace import Window

# mip-NeRF's flax layers and the program's names of them
DENSE = {f"Dense_{i}": f"pts_linears.{i}" for i in range(8)}
DENSE.update(Dense_8="alpha_linear", Dense_9="feature_linear",
             Dense_10="views_linears.0", Dense_11="rgb_linear")


def dense_dims(net: dict) -> dict:
    """{Dense_i: (in, out)} of mip-NeRF's MLP for ``net``."""
    W, Wc = net["net_width"], net["net_width_condition"]
    ipe = 2 * 3 * (net["max_deg_point"] - net["min_deg_point"])
    views = 3 + 2 * 3 * net["deg_view"]
    dims, d_in = {}, ipe
    for i in range(net["net_depth"]):
        dims[f"Dense_{i}"] = (d_in, W)
        d_in = W + (ipe if i % net["skip_layer"] == 0 and i > 0 else 0)
    n = net["net_depth"]
    dims[f"Dense_{n}"] = (d_in, net["num_density_channels"])
    dims[f"Dense_{n + 1}"] = (d_in, W)
    dims[f"Dense_{n + 2}"] = (W + views, Wc)
    dims[f"Dense_{n + 3}"] = (Wc, net["num_rgb_channels"])
    return dims


def mip_tree(net: dict, seed: int, device) -> dict:
    """The cell's network as mip-NeRF's flax tree ({Dense_i: {"kernel":
    (in, out), "bias"}}), from one draw on ``device``: every kernel and bias
    U(-1/sqrt(in), 1/sqrt(in)), then the density layer's kernel x40 and
    bias +0.5, the rgb layer's kernel x20 (scene.uniform_networks'
    recipe)."""
    dims = dense_dims(net)
    sizes = [(i + 1) * o for i, o in dims.values()]
    g = torch.Generator(device=device).manual_seed(
        scene.sub_seed(seed, scene.WEIGHTS))
    draw = torch.rand(sum(sizes), generator=g, device=device)
    tree = {}
    for (name, (i, o)), part in zip(dims.items(), draw.split(sizes)):
        part = (part * 2.0 - 1.0) / math.sqrt(i)
        tree[name] = {"kernel": part[:i * o].view(i, o),
                      "bias": part[i * o:]}
    n = net["net_depth"]
    tree[f"Dense_{n}"]["kernel"].mul_(40.0)
    tree[f"Dense_{n}"]["bias"].add_(0.5)
    tree[f"Dense_{n + 3}"]["kernel"].mul_(20.0)
    return tree


def camera_K(cam: dict) -> np.ndarray:
    """The intrinsics, the principal point half a pixel up and left when
    rays go through the pixels' centres."""
    K = scene.intrinsics(cam)
    if cam.get("pixel_centres"):
        K = K.copy()
        K[0, 2] -= 0.5
        K[1, 2] -= 0.5
    return K


def training_draws(n_steps: int, n_rays: int, n_edges: int, seed: int,
                   device):
    """The first ``n_steps`` steps' draws: ``t_rand`` and ``u``, each
    (n_rays, n_edges) U(0, 1), one draw of each kind on ``device``."""
    g = torch.Generator(device=device).manual_seed(
        scene.sub_seed(seed, scene.DRAWS))
    t_rand = torch.rand((n_steps, n_rays, n_edges), generator=g,
                        device=device)
    u = torch.rand((n_steps, n_rays, n_edges), generator=g, device=device)
    return [{"t_rand": t_rand[i], "u": u[i]} for i in range(n_steps)]


def reference_batches(images, poses, K, n_rand, seed, n, device):
    """The program batcher's first ``n`` "image" batches, worked out again
    from its seed (a view, then ``n_rand`` of its pixels without
    replacement), as the reference takes them: ((origins, directions,
    viewdirs, radii (n_rand, 1)), pixels), the radii from the view's whole
    grid of directions (``ref.pixel_radii``)."""
    rng = np.random.default_rng(seed)
    H, W = images.shape[1:3]
    n_rand = min(n_rand, H * W)
    out, radii = [], {}
    for _ in range(n):
        v = int(rng.choice(np.arange(len(images))))
        sel = rng.choice(H * W, size=n_rand, replace=False)
        ys, xs = sel // W, sel % W
        ro, rd = scene.rays_np(H, W, K, poses[v])
        if v not in radii:
            radii[v] = ref.pixel_radii(torch.as_tensor(rd, device=device))
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
        d = rd[ys, xs]
        vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
        ys_t, xs_t = t(ys), t(xs)
        out.append(((t(ro[ys, xs]), t(d), t(vd),
                     radii[v][ys_t, xs_t].contiguous()),
                    t(images[v][ys, xs])))
    return out


def sized(cfg: dict, sizes):
    if not sizes:
        return cfg
    cam = dict(cfg["camera"], H=sizes["H"], W=sizes["W"])
    samp = dict(cfg["sampling"], num_samples=sizes.get(
        "num_samples", cfg["sampling"]["num_samples"]))
    train = dict(cfg["train"], batch_size=sizes.get(
        "N_rand", cfg["train"]["batch_size"]))
    return dict(cfg, camera=cam, sampling=samp, train=train)


def run(r: harness.Run) -> harness.Outcome:
    cfg = sized(r.cfg, r.sizes)
    wl, dev = r.wl, r.device
    net, samp, cam, rnd = cfg["net"], cfg["sampling"], cfg["camera"], \
        cfg["render"]
    opt = wl["lsa"]
    n_rand = cfg["train"]["batch_size"]
    k = opt["steps_per_call"]
    n_check = 1 + k * opt["check_calls"]
    tree = mip_tree(net, r.seed, dev)
    images, poses, _K = scene.training_views(cam, cfg["train"]["train_views"],
                                             r.seed)
    K = camera_K(cam)
    draws = training_draws(n_check, n_rand, samp["num_samples"] + 1, r.seed,
                           dev)
    batch_seed = scene.sub_seed(r.seed, scene.BATCHER)
    out, window, steps, memory = {}, None, 0, 0
    if r.control != "tf32":
        out, window, steps, memory = _program(
            r, cfg, tree, images, poses, K, draws, n_rand, n_check, k,
            batch_seed)
    batches = reference_batches(images, poses, K, n_rand, batch_seed,
                                n_check, dev)
    follow = lambda tf32: ref.follow_lsa(
        tree, batches, draws, rnd["near"], rnd["far"], opt["learning_rate"],
        tf32=tf32, white_bkgd=rnd["white_bkgd"],
        block_rays=opt["reference_block_rays"],
        num_samples=samp["num_samples"])
    want = _named(follow(False))
    if r.control == "tf32":
        out = _named(follow(True))
        memory = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
    limits = wl["limits"]
    loss = [harness.gap(a, b) for a, b in zip(out["losses"], want["losses"])]
    grad = harness.norm_gaps(out["grad1"], want["grad1"])
    change = harness.norm_gaps(out["change"], want["change"])
    numbers = {"loss1_gap": loss[0], "loss_gap_median": float(np.median(loss)),
               "grad_gap_median": float(np.median(grad)),
               "change_gap": max(change)}
    checks = {name: (v, limits[name]) for name, v in numbers.items()}
    points = steps * n_rand * samp["num_levels"] * samp["num_samples"]
    metrics = {}
    if window is not None:
        metrics["lsa_rays_per_s"] = n_rand * steps / window.seconds
    counts = {"points": points, "requests": steps,
              "model_flops": points * kb1_ipe.train_flops(net),
              "kb1_ops": kb1_ipe.operations(net, points),
              "kb1_bytes": kb1_ipe.bytes_moved(net, points),
              "calls_s": out.get("calls_s", []),
              "detail": {"loss": loss, "grad1": grad, "change": change}}
    return harness.Outcome(
        metrics=metrics, attempted=steps, failed=0, checks=checks,
        memory_peak=memory, trace=window.summary() if window else None,
        counts=counts,
        setup_end=window.t_start if window else time.perf_counter())


def _named(follow: dict) -> dict:
    """The reference's leaves under the program's layer names."""
    return {"losses": follow["losses"],
            "grad1": {DENSE[k]: v for k, v in follow["grad1"].items()},
            "change": {DENSE[k]: v for k, v in follow["change"].items()}}


def _program(r, cfg, tree, images, poses, K, draws, n_rand, n_check, k,
             batch_seed):
    """The program's set-up, its window and what the comparison reads."""
    from nnc_tpu_torch.data.rays import RayBatcher
    from nnc_tpu_torch.models import nerf as pnerf
    from nnc_tpu_torch.render import mipnerf
    from nnc_tpu_torch.train import lsa
    from nnc_tpu_torch.utils.logging import read_result_file

    dev, opt, rnd, samp = r.device, r.wl["lsa"], cfg["render"], \
        cfg["sampling"]
    near, far = rnd["near"], rnd["far"]
    # as the CLI makes it from the configuration's keys (which must be the
    # published ones)
    net = cfg["net"]
    rc = mipnerf.make_render_config({"K": K, "white_bkgd": rnd["white_bkgd"],
                                     "mip": {
        "num_samples": samp["num_samples"],
        "num_levels": samp["num_levels"],
        "resample_padding": samp["resample_padding"],
        "min_deg_point": net["min_deg_point"],
        "max_deg_point": net["max_deg_point"], "deg_view": net["deg_view"],
        "density_bias": samp["density_bias"],
        "rgb_padding": samp["rgb_padding"],
        "coarse_loss_mult": cfg["train"]["coarse_loss_mult"]}})
    args = dict(learning_rate=opt["learning_rate"],
                learning_rate_decay=opt["learning_rate_decay"], epochs=1,
                verbose=False, steps_per_call=k,
                seed=scene.sub_seed(r.seed, scene.PROGRAM))

    def built():
        return pnerf.init_lsa_scales(pnerf.from_mipnerf_params(
            tree, device=dev))

    def feed(seed):
        return Feed(RayBatcher(images, poses, K, np.arange(len(images)),
                               n_rand, seed=seed), cfg["camera"], False)

    # warm-up on a copy: the kernels are built and a replayed call timed
    warm, rate = built(), {}
    lsa.tune_lsa_scales(warm, None, feed(batch_seed + 1), rc, near, far,
                        n_iters=n_check, stats=rate, **args)
    del warm
    harness.free_device(dev)
    replays = [s / n for n, s, captured in rate["calls"]
               if n == k and not captured]
    step_s = min(replays) if replays else \
        max(rate["calls"][-1][1] - rate["capture_s"], 1e-3) / k
    model = built()
    names = list(model.layers())
    fed = feed(batch_seed)
    n_steps = window_steps(r.seconds, step_s, k, n_check)
    n_iters = n_check + n_steps
    states, checked, stats = {}, {}, {}
    fed.at_window = lambda: checked.update(
        {n: layer.weight_scaling.detach().clone()
         for n, layer in model.layers().items()})
    tmp = tempfile.mkdtemp(prefix="lsa_mip_")
    try:
        with Window(r.trace, dev.type) as window:
            fed.window, fed.window_after = window, n_check
            lsa.tune_lsa_scales(
                model, None, fed, rc, near, far, n_iters=n_iters,
                i_save=n_iters + 1, basedir_save=tmp, stats=stats,
                save_hook=lambda step, _c, _f, st: states.__setitem__(
                    step, st),
                draws=lambda i: draws[i] if i < n_check else {}, **args)
            window.stop()
        losses = read_result_file(os.path.join(tmp, "result.txt"))[1]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else 0
    grad1 = _leaf_norms_state(states[1]["adam"], names)
    change = {n: float(torch.linalg.norm(t - 1.0))
              for n, t in checked.items()}
    n_first = 1 + opt["check_calls"]       # step 1 alone, then full calls
    del model, fed, checked
    harness.free_device(dev)
    out = {"losses": losses[:n_check], "grad1": grad1, "change": change,
           "calls_s": [s for _n, s, captured in stats["calls"][n_first:]
                       if not captured]}
    return out, window, n_steps, memory
