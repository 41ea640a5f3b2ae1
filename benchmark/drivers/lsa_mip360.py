"""mip-NeRF 360's LSA cell: the CLI's tuning loop, ``lsa.tune_lsa_scales``,
on mip-NeRF 360's three-term loss (``render/mipnerf360.py``), the proposal
MLP as the coarse network and the NeRF MLP as the fine one, every layer a
GEMM and K-B7, in calls of ``steps_per_call`` steps (one CUDA-graph replay a
call on the card), on the program's pooled ``RayBatcher`` over the cell's
training views.

The run is ``drivers/lsa.py``'s: set-up runs a few calls on copies of the
networks to build the kernels and read the rate of a replayed call; one
``tune_lsa_scales`` call then runs the cell, its first ``1 +
steps_per_call * check_calls`` steps on the benchmark's draws compared, the
window from the batches of the next call to the call's return, whole calls
before the pool's first reshuffle. The losses come from the run's
``result.txt``, the optimizer's state after step 1 from ``save_hook``, the
scales after the compared steps from the networks when the window's first
batches are asked for.

After the window the reference (``reference/mipnerf360.py``, in
multinerf's own layer and channel order, the weights as the same flax tree)
follows the compared steps from the same weights, batches (worked out again
from the batcher's seed, each ray's radius measured between neighbouring
rows of its view as the published loader measures it) and draws, in blocks
of ``reference_block_rays`` rays. The comparison is ``drivers/lsa.py``'s:
the first step's loss gap, the median step's, the median leaf's gradient
gap and the worst leaf's change gap.
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
from benchmark.counts import mlp360
from benchmark.drivers.lsa import Feed, _leaf_norms_state, window_steps
from benchmark.reference import mipnerf360 as ref
from benchmark.trace import Window

MLPS = ("prop", "nerf")


def flax_names(net: dict) -> dict:
    """{tree key: {Dense_i: the program's layer}} in creation order."""
    out = {}
    for mlp in MLPS:
        names = {}
        for i, layer in enumerate(mlp360.dims(net, mlp)):
            names[f"Dense_{i}"] = (
                f"pts_linears.{layer[5:]}" if layer.startswith("trunk")
                else {"density": "alpha_linear",
                      "bottleneck": "feature_linear",
                      "view": "views_linears.0", "rgb": "rgb_linear"}[layer])
        out[mlp + "_mlp"] = names
    return out


def m360_tree(net: dict, seed: int, device) -> dict:
    """Both MLPs as multinerf's flax tree ({"prop_mlp" | "nerf_mlp":
    {Dense_i: {"kernel": (in, out), "bias"}}}), from one draw on
    ``device``: every kernel and bias U(-1/sqrt(in), 1/sqrt(in)), then each
    density layer's kernel x40 and bias +0.5, the rgb layer's kernel x20
    (scene.uniform_networks' recipe)."""
    layers = [(mlp, i, o) for mlp in MLPS
              for i, o in mlp360.dims(net, mlp).values()]
    sizes = [(i + 1) * o for _m, i, o in layers]
    g = torch.Generator(device=device).manual_seed(
        scene.sub_seed(seed, scene.WEIGHTS))
    draw = torch.rand(sum(sizes), generator=g, device=device)
    tree = {mlp + "_mlp": {} for mlp in MLPS}
    for (mlp, i, o), part in zip(layers, draw.split(sizes)):
        part = (part * 2.0 - 1.0) / math.sqrt(i)
        t = tree[mlp + "_mlp"]
        t[f"Dense_{len(t)}"] = {"kernel": part[:i * o].view(i, o),
                                "bias": part[i * o:]}
    for mlp in MLPS:
        depth = net[mlp + "_depth"]
        t = tree[mlp + "_mlp"]
        t[f"Dense_{depth}"]["kernel"].mul_(40.0)
        t[f"Dense_{depth}"]["bias"].add_(0.5)
        if mlp == "nerf":
            t[f"Dense_{depth + 3}"]["kernel"].mul_(20.0)
    return tree


def camera_K(cam: dict) -> np.ndarray:
    """The intrinsics, the principal point half a pixel up and left: rays
    through the pixels' centres."""
    K = scene.intrinsics(cam).copy()
    K[0, 2] -= 0.5
    K[1, 2] -= 0.5
    return K


def training_draws(n_steps: int, n_rays: int, seed: int, device):
    """The first ``n_steps`` steps' draws: ``jitter`` (n_rays, 3) U(0, 1),
    one a level, in one draw on ``device``."""
    g = torch.Generator(device=device).manual_seed(
        scene.sub_seed(seed, scene.DRAWS))
    jitter = torch.rand((n_steps, n_rays, 3), generator=g, device=device)
    return [{"jitter": jitter[i]} for i in range(n_steps)]


def reference_batches(images, poses, K, n_rand, seed, n, device):
    """The program batcher's first ``n`` "pool" batches, worked out again
    from its seed (the rays of every view, a view's pixels in row order,
    view after view, shuffled by an index permutation and walked, shuffled
    again when a batch would run past the end), as the reference takes
    them: ((origins, directions, viewdirs, radii (n_rand, 1)), pixels), the
    radii from each view's whole grid of directions."""
    rng = np.random.default_rng(seed)
    n_views, H, W = images.shape[:3]
    rays = [scene.rays_np(H, W, K, p) for p in poses]
    ro_all, rd_all = (np.stack([r[i] for r in rays]) for i in (0, 1))
    radii = np.stack([_pixel_radii(rd) for _ro, rd in rays])
    order = np.arange(n_views * H * W)
    rng.shuffle(order)
    at, out = 0, []
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    for _ in range(n):
        if at + n_rand > order.shape[0]:
            rng.shuffle(order)
            at = 0
        v, px = np.divmod(order[at:at + n_rand], H * W)
        ys, xs = np.divmod(px, W)
        at += n_rand
        d = rd_all[v, ys, xs]
        vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
        out.append(((t(ro_all[v, ys, xs]), t(d), t(vd),
                     t(radii[v, ys, xs][:, None])), t(images[v, ys, xs])))
    return out


def _pixel_radii(directions: np.ndarray) -> np.ndarray:
    """(H, W) radii of a view's (H, W, 3) directions: the distance to the
    neighbour in the next row (the last row repeats the one before), times
    2 / sqrt(12) (multinerf's datasets.py)."""
    dx = np.sqrt(np.sum((directions[:-1] - directions[1:]) ** 2, -1))
    dx = np.concatenate([dx, dx[-2:-1]], 0)
    return (dx * 2 / np.sqrt(12)).astype(np.float32)


def sizes_of(cfg: dict) -> ref.Sizes:
    net, samp = cfg["net"], cfg["sampling"]
    return ref.Sizes(
        prop_depth=net["prop_depth"], prop_width=net["prop_width"],
        nerf_depth=net["nerf_depth"], nerf_width=net["nerf_width"],
        bottleneck=net["bottleneck_width"],
        view_width=net["net_width_viewdirs"],
        num_prop_samples=samp["num_prop_samples"],
        num_nerf_samples=samp["num_nerf_samples"],
        min_deg_point=net["min_deg_point"],
        max_deg_point=net["max_deg_point"], deg_view=net["deg_view"])


def sized(cfg: dict, sizes):
    """The configuration at a CPU test's sizes: ``H``, ``W``, ``N_rand``,
    the widths ``nerf_width`` / ``prop_width`` / ``bottleneck_width`` /
    ``net_width_viewdirs``, ``max_deg_point`` and the samples."""
    if not sizes:
        return cfg
    cam = dict(cfg["camera"], H=sizes["H"], W=sizes["W"])
    net = dict(cfg["net"], **{k: sizes[k] for k in (
        "nerf_width", "prop_width", "bottleneck_width", "net_width_viewdirs",
        "max_deg_point") if k in sizes})
    samp = dict(cfg["sampling"], **{k: sizes[k] for k in (
        "num_prop_samples", "num_nerf_samples") if k in sizes})
    train = dict(cfg["train"], batch_size=sizes.get(
        "N_rand", cfg["train"]["batch_size"]))
    return dict(cfg, camera=cam, net=net, sampling=samp, train=train)


def run(r: harness.Run) -> harness.Outcome:
    cfg = sized(r.cfg, r.sizes)
    wl, dev = r.wl, r.device
    net, samp, rnd = cfg["net"], cfg["sampling"], cfg["render"]
    opt = wl["lsa"]
    n_rand = cfg["train"]["batch_size"]
    k = opt["steps_per_call"]
    n_check = 1 + k * opt["check_calls"]
    tree = m360_tree(net, r.seed, dev)
    images, poses, _K = scene.training_views(
        cfg["camera"], cfg["train"]["train_views"], r.seed)
    K = camera_K(cfg["camera"])
    draws = training_draws(n_check, n_rand, r.seed, dev)
    batch_seed = scene.sub_seed(r.seed, scene.BATCHER)
    out, window, steps, memory = {}, None, 0, 0
    if r.control != "tf32":
        out, window, steps, memory = _program(
            r, cfg, tree, images, poses, K, draws, n_rand, n_check, k,
            batch_seed)
    batches = reference_batches(images, poses, K, n_rand, batch_seed,
                                n_check, dev)
    follow = lambda tf32: ref.follow_lsa(
        tree, batches, draws, sizes_of(cfg), opt["learning_rate"],
        tf32=tf32, block_rays=opt["reference_block_rays"],
        near=rnd["near"], far=rnd["far"])
    want = _named(follow(False), net)
    if r.control == "tf32":
        out = _named(follow(True), net)
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
    per_ray = sum(mlp360.points_a_ray(samp).values())
    metrics = {}
    if window is not None:
        metrics["lsa_rays_per_s"] = n_rand * steps / window.seconds
    counts = {"points": steps * n_rand * per_ray, "requests": steps,
              "model_flops": steps * mlp360.step_flops(net, samp, n_rand),
              "mlp360_ops": steps * mlp360.step_flops(net, samp, n_rand),
              "kb7_bytes": steps * mlp360.kb7_bytes(net, samp, n_rand),
              "calls_s": out.get("calls_s", []),
              "detail": {"loss": loss, "grad1": grad, "change": change}}
    return harness.Outcome(
        metrics=metrics, attempted=steps, failed=0, checks=checks,
        memory_peak=memory, trace=window.summary() if window else None,
        counts=counts,
        setup_end=window.t_start if window else time.perf_counter())


def _named(follow: dict, net: dict) -> dict:
    """The reference's leaves under the program's tags and layer names
    (``c.`` the proposal MLP, ``f.`` the NeRF MLP)."""
    names = flax_names(net)
    tag = {"prop_mlp": "c", "nerf_mlp": "f"}
    rename = lambda leaf: "{}.{}".format(
        tag[leaf.split(".")[0]], names[leaf.split(".")[0]][
            leaf.split(".")[1]])
    return {"losses": follow["losses"],
            "grad1": {rename(k): v for k, v in follow["grad1"].items()},
            "change": {rename(k): v for k, v in follow["change"].items()}}


def _program(r, cfg, tree, images, poses, K, draws, n_rand, n_check, k,
             batch_seed):
    """The program's set-up, its window and what the comparison reads."""
    from nnc_tpu_torch.data.rays import RayBatcher
    from nnc_tpu_torch.models import mipnerf360 as pm360
    from nnc_tpu_torch.models import nerf as pnerf
    from nnc_tpu_torch.render import mipnerf360
    from nnc_tpu_torch.train import lsa
    from nnc_tpu_torch.utils.logging import read_result_file

    dev, opt, rnd = r.device, r.wl["lsa"], cfg["render"]
    net, samp, train = cfg["net"], cfg["sampling"], cfg["train"]
    near, far = rnd["near"], rnd["far"]
    # as the CLI makes it from the configuration's keys (which must be the
    # published ones); the CPU tests' sizes set the MLPs and samples
    keys = {"num_levels": samp["num_levels"],
            "dilation_bias": samp["dilation_bias"],
            "dilation_multiplier": samp["dilation_multiplier"],
            "resample_padding": samp["resample_padding"],
            "min_deg_point": net["min_deg_point"],
            "deg_view": net["deg_view"], "density_bias": samp["density_bias"],
            "rgb_padding": samp["rgb_padding"],
            "charb_padding": train["charb_padding"],
            "interlevel_loss_mult": train["interlevel_loss_mult"],
            "distortion_loss_mult": train["distortion_loss_mult"]}
    rc = mipnerf360.make_render_config({"K": K, "mip360": keys})
    if r.sizes:
        enc = 2 * 21 * (net["max_deg_point"] - net["min_deg_point"])
        cfg_of = lambda mlp: pm360.MLP360Config(
            depth=net[mlp + "_depth"], width=net[mlp + "_width"],
            input_ch=enc, rgb=mlp == "nerf",
            bottleneck=net["bottleneck_width"],
            view_width=net["net_width_viewdirs"])
        rc = mipnerf360.Mip360RenderConfig(
            prop=cfg_of("prop"), nerf=cfg_of("nerf"),
            num_prop_samples=samp["num_prop_samples"],
            num_nerf_samples=samp["num_nerf_samples"],
            max_deg_point=net["max_deg_point"],
            pixel_radius=rc.pixel_radius)
    args = dict(learning_rate=opt["learning_rate"],
                learning_rate_decay=opt["learning_rate_decay"], epochs=1,
                verbose=False, steps_per_call=k,
                seed=scene.sub_seed(r.seed, scene.PROGRAM))

    def built():
        models = pm360.from_mipnerf360_params(tree, device=dev,
                                              prop=rc.prop, nerf=rc.nerf)
        for m in models:
            pnerf.init_lsa_scales(m)
        return models

    def feed(seed):
        return Feed(RayBatcher(images, poses, K, np.arange(len(images)),
                               n_rand, mode="pool", seed=seed),
                    cfg["camera"], False)

    # warm-up on copies: the kernels are built and a replayed call timed
    warm, rate = built(), {}
    lsa.tune_lsa_scales(*warm, feed(batch_seed + 1), rc, near, far,
                        n_iters=n_check, stats=rate, **args)
    del warm
    harness.free_device(dev)
    replays = [s / n for n, s, captured in rate["calls"]
               if n == k and not captured]
    step_s = min(replays) if replays else \
        max(rate["calls"][-1][1] - rate["capture_s"], 1e-3) / k
    models = built()
    names = [f"{tag}.{name}" for tag, m in zip("cf", models)
             for name in m.layers()]
    fed = feed(batch_seed)
    epoch = fed.batcher.pool.shape[0] // fed.batcher.n_rand
    n_steps = window_steps(r.seconds, step_s, k, n_check, epoch)
    n_iters = n_check + n_steps
    states, checked, stats = {}, {}, {}
    fed.at_window = lambda: checked.update(
        {f"{tag}.{n}": layer.weight_scaling.detach().clone()
         for tag, m in zip("cf", models) for n, layer in m.layers().items()})
    tmp = tempfile.mkdtemp(prefix="lsa_m360_")
    try:
        with Window(r.trace, dev.type) as window:
            fed.window, fed.window_after = window, n_check
            lsa.tune_lsa_scales(
                *models, fed, rc, near, far, n_iters=n_iters,
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
    del models, fed, checked
    harness.free_device(dev)
    out = {"losses": losses[:n_check], "grad1": grad1, "change": change,
           "calls_s": [s for _n, s, captured in stats["calls"][n_first:]
                       if not captured]}
    return out, window, n_steps, memory
