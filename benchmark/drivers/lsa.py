"""LSA cells: the CLI's tuning loop, ``lsa.tune_lsa_scales``, in calls of
``steps_per_call`` steps (one CUDA-graph replay a call on the card) on the
program's ``RayBatcher`` over the cell's training views.

Set-up first runs a few calls on copies of the models, on a batcher of
their own, to build the kernels and read the rate of a replayed call. Then
one ``tune_lsa_scales`` call runs the cell: its first ``1 + steps_per_call
* check_calls`` steps, as the CLI runs them (step 1 alone, then full calls,
the first of which captures the graph), on the benchmark's draws, are
set-up and are compared; the window runs from the batches of the next call
to the call's return, through the same graph, state and batcher. The
losses come from the run's ``result.txt``, the optimizer's state after
step 1 from ``save_hook``, and the scales after the compared steps from the
models when the window's first batches are asked for.

With a pool of rays the window ends just after the batcher's reshuffle of
the pool, so that it holds whole passes over the pool and as many
reshuffles; a window shorter than a pass holds none.

After the window the reference follows the compared steps from the same
weights, batches (worked out again from the batcher's seed) and draws. The
comparison takes each step's loss, each leaf's first gradient (its norm,
from Adam's first moment after step 1) and each leaf's change over the
followed steps (its norm), each as a gap relative to the reference, and
holds: the first step's loss gap, the median step's, the median leaf's
gradient gap and the worst leaf's change gap. A single step's loss or a
single leaf's gradient can move on float32 rounding alone, where a sample
of ``sample_pdf`` or a ReLU sits at its edge (PERF.md, Findings), so
the later steps and the gradients are held by their medians.
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
from benchmark.counts import kb1, model as model_counts
from benchmark.reference import nerf as ref
from benchmark.trace import Window

BETA1 = 0.9


class Feed:
    """The program's batcher as the run hands it over: NDC-warped for
    forward-facing scenes (the view directions before the warp). When the
    batches of step ``window_after`` are asked for, the compared steps have
    ended: ``at_window()`` runs, then the window starts."""

    def __init__(self, batcher, camera, ndc: bool):
        self.batcher, self.camera, self.ndc = batcher, camera, ndc
        self.window, self.window_after, self.asked = None, None, 0
        self.at_window = None

    def next_batch(self):
        if self.window is not None and self.asked == self.window_after:
            self.at_window()
            self.window.start()
        self.asked += 1
        ro, rd, target = self.batcher.next_batch()
        if not self.ndc:
            return ro, rd, target
        return warp(ro, rd, target, self.camera)


def warp(ro, rd, target, camera):
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    ro_n, rd_n = scene.ndc_np(camera["H"], camera["W"],
                              scene.focal_of(camera), 1.0, ro, rd)
    return ro_n, rd_n, vd.astype(np.float32), target


def reference_batches(images, poses, K, n_rand, mode, seed, n, camera,
                      ndc):
    """The program batcher's first ``n`` batches, worked out again from its
    seed: "image" draws a view, then ``n_rand`` pixels without replacement;
    "pool" shuffles the rays of every view (a view's pixels in row order,
    view after view) and walks them, shuffling again when a batch would
    run past the end. The pool's shuffle is worked out on the rays'
    indices: the same draws permute an index vector as they permute the
    pool's rows."""
    rng = np.random.default_rng(seed)
    H, W = images.shape[1:3]
    n_rand = min(n_rand, H * W)
    rays = [scene.rays_np(H, W, K, p) for p in poses]
    out = []
    if mode == "pool":
        ro_all, rd_all = (np.stack([r[i] for r in rays]) for i in (0, 1))
        order = np.arange(len(images) * H * W)
        rng.shuffle(order)
        at = 0
        for _ in range(n):
            if at + n_rand > order.shape[0]:
                rng.shuffle(order)
                at = 0
            v, px = np.divmod(order[at:at + n_rand], H * W)
            ys, xs = np.divmod(px, W)
            at += n_rand
            out.append((ro_all[v, ys, xs], rd_all[v, ys, xs],
                        images[v, ys, xs]))
    else:
        views = np.arange(len(images))
        for _ in range(n):
            v = rng.choice(views)
            sel = rng.choice(H * W, size=n_rand, replace=False)
            ys, xs = sel // W, sel % W
            out.append((rays[v][0][ys, xs], rays[v][1][ys, xs],
                        images[v][ys, xs]))
    if ndc:
        return [warp(*b, camera) for b in out]
    return [(ro, rd, rd / np.linalg.norm(rd, axis=-1, keepdims=True), t)
            for ro, rd, t in out]


def window_steps(seconds, step_s, k, n_check, epoch=None):
    """The window's steps, whole calls of ``k``: about ``seconds`` at
    ``step_s`` a step; with a pool of ``epoch`` batches between reshuffles,
    the whole passes that come nearest (the window ends just after the
    last pass's reshuffle), or, nearer none, only steps before the first
    reshuffle."""
    if epoch is None:
        return k * max(1, round(seconds / (k * step_s)))
    passes = round(seconds / (epoch * step_s))
    if passes:
        return k * math.ceil((passes * epoch + 1 - n_check) / k)
    fit = (epoch - n_check) // k
    return k * max(1, min(fit, round(seconds / (k * step_s))))


def _leaf_norms_state(state, names):
    """{leaf: norm of the first gradient} from Adam's state after one step
    (its first moment is (1 - beta1) g)."""
    return {n: float(torch.linalg.norm(state["state"][i]["exp_avg"]
                                       / (1 - BETA1)))
            for i, n in enumerate(names)}


def run(r: harness.Run) -> harness.Outcome:
    cfg, wl = r.cfg, r.wl
    net, samp, cam = cfg["net"], cfg["sampling"], cfg["camera"]
    rnd, train, opt = cfg["render"], cfg["train"], wl["lsa"]
    dev = r.device
    n_rand = r.size("N_rand", train["N_rand"])
    k = opt["steps_per_call"]
    n_check = 1 + k * opt["check_calls"]
    ndc = cam["rig"] == "forward"
    mode = "image" if train["no_batching"] else "pool"
    if r.sizes:
        cam = dict(cam, H=r.sizes["H"], W=r.sizes["W"])
        samp = dict(samp, **{key: r.sizes[key] for key in
                             ("N_samples", "N_importance") if key in r.sizes})
        cfg = dict(cfg, sampling=samp, camera=cam)
    nets = scene.networks(net, wl["teacher"], 2, r.seed, dev)
    images, poses, K = scene.training_views(cam, train["train_views"], r.seed)
    draws = scene.training_draws(n_check, n_rand, samp,
                                 samp["raw_noise_std"] > 0, r.seed, dev)
    batch_seed = scene.sub_seed(r.seed, scene.BATCHER)
    ref_render = dict(samp, near=rnd["near"], far=rnd["far"],
                      white_bkgd=rnd["white_bkgd"])
    out = {}
    if r.control == "tf32":
        window = None
        steps = 0
    else:
        out, window, steps, memory = _program(
            r, cfg, nets, images, poses, K, draws, n_rand, n_check, k, mode,
            batch_seed, ndc)
    batches = [tuple(torch.as_tensor(a, device=dev) for a in b)
               for b in reference_batches(images, poses, K, n_rand, mode,
                                          batch_seed, n_check, cam, ndc)]
    want = ref.follow_lsa(net, ref_render, nets, batches, draws,
                          opt["learning_rate"])
    if r.control == "tf32":
        got = ref.follow_lsa(net, ref_render, nets, batches, draws,
                             opt["learning_rate"], tf32=True)
        out = {"losses": got["losses"], "grad1": got["grad1"],
               "change": got["change"]}
        memory = torch.cuda.max_memory_allocated(dev) \
            if dev.type == "cuda" else 0
    limits = wl["limits"]
    loss = [harness.gap(a, b) for a, b in zip(out["losses"], want["losses"])]
    grad = harness.norm_gaps(out["grad1"], want["grad1"])
    change = harness.norm_gaps(out["change"], want["change"])
    numbers = {"loss1_gap": loss[0], "loss_gap_median": float(np.median(loss)),
               "grad_gap_median": float(np.median(grad)),
               "change_gap": max(change)}
    checks = {k: (v, limits[k]) for k, v in numbers.items()}
    points = steps * n_rand * (2 * samp["N_samples"] + samp["N_importance"])
    metrics = {}
    if window is not None:
        metrics[wl.get("metric", "lsa_rays_per_s")] = \
            n_rand * steps / window.seconds
    counts = {"points": points,
              "model_flops": points * model_counts.train_flops(net),
              "kb1_ops": kb1.operations(net, points),
              "kb1_bytes": kb1.bytes_moved(net, points),
              "calls_s": out.get("calls_s", []),
              "requests": steps,
              "detail": {"loss": loss, "grad1": grad, "change": change}}
    return harness.Outcome(
        metrics=metrics, attempted=steps, failed=0, checks=checks,
        memory_peak=memory, trace=window.summary() if window else None,
        counts=counts,
        setup_end=window.t_start if window else time.perf_counter())


def _scales(models):
    return {f"{tag}.{name}": layer.weight_scaling.detach().clone()
            for tag, m in zip("cf", models)
            for name, layer in m.layers().items()}


def _program(r, cfg, nets, images, poses, K, draws, n_rand, n_check, k,
             mode, batch_seed, ndc):
    """The program's set-up, its window and what the comparison reads."""
    from nnc_tpu_torch.data.rays import RayBatcher
    from nnc_tpu_torch.models import nerf as pnerf
    from nnc_tpu_torch.train import lsa
    from nnc_tpu_torch.utils.logging import read_result_file

    dev, opt, rnd = r.device, r.wl["lsa"], cfg["render"]
    near, far = rnd["near"], rnd["far"]
    rc = harness.render_config(cfg, r.compute_dtype)
    args = dict(learning_rate=opt["learning_rate"],
                learning_rate_decay=opt["learning_rate_decay"], epochs=1,
                verbose=False, steps_per_call=k,
                seed=scene.sub_seed(r.seed, scene.PROGRAM))

    def built():
        models = [harness.port_model(w, cfg, dev, r.compute_dtype)
                  for w in nets]
        for m in models:
            pnerf.init_lsa_scales(m)
        return models

    # warm-up on copies: the kernels are built and a replayed call timed
    warm, rate = built(), {}
    lsa.tune_lsa_scales(
        *warm, Feed(RayBatcher(images, poses, K, np.arange(len(images)),
                               n_rand, seed=batch_seed + 1),
                    cfg["camera"], ndc),
        rc, near, far, n_iters=n_check, stats=rate, **args)
    del warm
    replays = [s / n for n, s, captured in rate["calls"]
               if n == k and not captured]
    step_s = min(replays) if replays else \
        max(rate["calls"][-1][1] - rate["capture_s"], 1e-3) / k
    models = built()
    names = [f"{tag}.{name}" for tag, m in zip("cf", models)
             for name in m.layers()]
    feed = Feed(RayBatcher(images, poses, K, np.arange(len(images)), n_rand,
                           mode=mode, seed=batch_seed), cfg["camera"], ndc)
    epoch = feed.batcher.pool.shape[0] // feed.batcher.n_rand \
        if mode == "pool" else None     # batches between the reshuffles
    n_steps = window_steps(r.seconds, step_s, k, n_check, epoch)
    n_iters = n_check + n_steps
    states, checked, stats = {}, {}, {}
    feed.at_window = lambda: checked.update(_scales(models))
    tmp = tempfile.mkdtemp(prefix="lsa_")
    try:
        with Window(r.trace, dev.type) as window:
            feed.window, feed.window_after = window, n_check
            lsa.tune_lsa_scales(
                *models, feed, rc, near, far, n_iters=n_iters,
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
    del models, feed, checked
    harness.free_device(dev)
    out = {"losses": losses[:n_check], "grad1": grad1, "change": change,
           "calls_s": [s for _n, s, captured in stats["calls"][n_first:]
                       if not captured]}
    return out, window, n_steps, memory
