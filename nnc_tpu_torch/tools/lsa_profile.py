"""Where an LSA step's time goes on the card: wall, device-busy and idle share
of the step through K-B1 and through the plain MLP, in calls of
``--steps_per_call`` steps (one replay of a CUDA graph each) and in single
steps. Needs a CUDA device and nvcc:

    python -m nnc_tpu_torch.tools.lsa_profile [--dtype bfloat16]
        [--steps_per_call 8] [--occupancy]

``--dtype bfloat16`` tunes models built with
``NeRFConfig(compute_dtype=torch.bfloat16)``: K-B1's bf16 kernels, and the
plain bf16 MLP (the scale folded into the weight before rounding).
``--occupancy`` trains on the occupancy loss (a grid of the tuned fine
network at res 128, dilated once, 32 of 64 candidates a ray) instead of the
exact hierarchical render.

The scene is lego's geometry (400 x 400, focal 555.6, near 2, far 6, white
background, 64 + 128 samples, N_rand 1,024) on a solid full-width teacher;
the tuned models are the teacher with 5% noise on every weight. After the
card's name and power limit it prints, for each path (kernels, plain) the
K-step route and the one-step route in turns (K, 1, 1, K), each over
``ITERS_PER_K`` x K steps from fresh models (one epoch, no i_save, so every
call of the K-step route is full):
  * the mean step on the host clock over the calls that captured no graph,
    each timed from its batches to its loss readback, without the profiler;
  * under ``torch.profiler``, the device time of all kernels in the run per
    step run on the device (the graph's warm-up step included: device
    busy), the idle share 1 - busy / wall of the unprofiled step and of the
    profiled one, K-B1's share of the device time, the device events a
    step, and K-B1's launches in the unprofiled run (replays included);
  * the graph's capture seconds and the peak of its private pool.

To compare with a parent commit that predates ``--steps_per_call``, unpack
the parent under ``build/`` (``git archive <commit> | tar -x -C
build/parent``) and run the parent's tool from ``build/parent`` (its
one-step route) and this one on the same card, one after the other in one
shell command, in turns: parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from ..data import synthetic
from ..models import nerf
from ..ops import _build, mlp_train_fused
from ..render import occupancy, renderer
from ..train import lsa, presets
from ..utils import profiling
from ..utils.platform import card_line

HW = 400
FOCAL = 0.5 * HW / math.tan(0.5 * 0.6911112070083618)
ITERS_PER_K = 4
LR = 1e-3


def _scene(dev):
    g = torch.Generator().manual_seed(2)
    teachers = tuple(synthetic.make_solid_mlp(noise_std=1e-2, generator=g,
                                              device=dev) for _ in range(2))
    rc = renderer.RenderConfig(n_samples=64, n_importance=128,
                               white_bkgd=True)
    scene, _ = synthetic.make_scene(n_images=4, H=HW, W=HW, rc=rc, near=2.0,
                                    far=6.0, teachers=teachers, focal=FOCAL,
                                    device=dev)
    scene.update(n_importance=128, raw_noise_std=0.0,
                 dataset_type="synthetic_lego")
    sd = nerf.params_to_state_dict(teachers[0], "model.")
    sd.update(nerf.params_to_state_dict(teachers[1], "model_fine."))
    rng = np.random.default_rng(7)
    noisy = {k: (np.asarray(v) * (1 + 0.05 * rng.standard_normal(
        np.shape(v)))).astype(np.float32) for k, v in sd.items()}
    return scene, noisy


def _tune(ex, models, steps_per_call, n_iters, grid, draws, stats):
    lsa.tune_lsa_scales(*models, ex._make_batcher(), ex.rc, ex.scene["near"],
                        ex.scene["far"], learning_rate=ex.learning_rate,
                        learning_rate_decay=0.0, epochs=1, n_iters=n_iters,
                        verbose=False, steps_per_call=steps_per_call,
                        grid=grid, draws=draws, stats=stats)


def _step_ms(stats):
    """Mean ms a step over the calls that captured no graph."""
    calls = [(k, s) for k, s, capturing in stats["calls"] if not capturing]
    return 1e3 * sum(s for _k, s in calls) / sum(k for k, _s in calls)


def measure(ex, make_models, steps_per_call, n_iters, grid=None,
            draws=None):
    """Two LSA runs of ``n_iters`` steps (one epoch, no i_save) on the
    executer's batches and render config, from ``make_models()`` each, in
    calls of ``steps_per_call``: one on the host clock, one under
    ``torch.profiler``. Returns a dict: ``step_ms`` (the calls that captured
    no graph), ``busy_ms`` (device time per step run on the device, the
    warm-up included), ``idle`` (1 - busy / step_ms), ``idle_profiled``,
    ``kb1_ms``, ``events`` (device events a step), ``launches`` (K-B1's, in
    the first run, replays included), ``capture_s`` and ``pool_mb``."""
    torch.cuda.synchronize()
    stats = {}
    before = _build.launch_counts()
    _tune(ex, make_models(), steps_per_call, n_iters, grid, draws, stats)
    after = _build.launch_counts()
    launches = {k: after[k] - before[k] for k in after
                if k.startswith("mlp_train") and after[k] > before[k]}
    prof_stats = {}
    with profiling.trace_if(None) as prof:
        _tune(ex, make_models(), steps_per_call, n_iters, grid, draws,
              prof_stats)
    events = [e for e in prof.key_averages() if profiling.device_us(e) > 0]
    run = n_iters + prof_stats["warmup_steps"]
    busy = sum(profiling.device_us(e) for e in events) / 1e3 / run
    step_ms = _step_ms(stats)
    return {"step_ms": step_ms, "busy_ms": busy,
            "idle": 1 - busy / step_ms,
            "idle_profiled": 1 - busy / _step_ms(prof_stats),
            "kb1_ms": sum(profiling.device_us(e) for e in events
                          if "mlp_train" in e.key) / 1e3 / run,
            "events": sum(e.count for e in events) / run,
            "launches": launches, "capture_s": stats["capture_s"],
            "pool_mb": stats["pool_bytes"] / 2 ** 20,
            "top": sorted(events, key=profiling.device_us, reverse=True)[:5],
            "run_steps": run}


def report(tag, steps_per_call, m):
    print(f"LSA step, {tag}, {steps_per_call} a call: {m['step_ms']:.3f} ms "
          f"wall; device busy {m['busy_ms']:.3f} ms a step, idle share "
          f"{100 * m['idle']:.1f}% ({100 * m['idle_profiled']:.1f}% of the "
          f"profiled step); K-B1 {m['kb1_ms']:.3f} ms = "
          f"{100 * m['kb1_ms'] / m['busy_ms']:.1f}% of the device time; "
          f"{m['events']:.0f} device events a step; K-B1 launches "
          f"{m['launches']}; capture {m['capture_s']:.3f} s, graph pool "
          f"{m['pool_mb']:.1f} MB")
    print("    most device time: " + "; ".join(
        f"{e.key[:48]} "
        f"{profiling.device_us(e) / 1e3 / m['run_steps']:.3f} ms x "
        f"{e.count / m['run_steps']:.0f}" for e in m["top"]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    ap.add_argument("--steps_per_call", type=int, default=8)
    ap.add_argument("--occupancy", action="store_true")
    args = ap.parse_args(argv)
    mlp = nerf.NeRFConfig(compute_dtype=getattr(torch, args.dtype))
    dev = torch.device("cuda", 0)
    print(card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.lib()
    scene, sd = _scene(dev)
    k = args.steps_per_call
    for fused in (True, False):
        ex = presets.create_nerf_model_executer(
            scene=scene, device=dev, use_fused_mlp=fused, mlp_config=mlp,
            learning_rate=LR, verbose=False)
        grid = None
        if args.occupancy:
            grid = occupancy.build_occupancy_grid(ex._split_params(sd)[1],
                                                  dilate=1)
        tag = ("K-B1" if fused else "plain") + \
            ("" if args.dtype == "float32" else " bf16") + \
            (", occupancy loss" if grid is not None else "")
        for spc in (k, 1, 1, k):
            report(tag, spc, measure(ex, lambda: ex._split_params(sd), spc,
                                     ITERS_PER_K * k, grid))
    cache = mlp_train_fused.TRAIN_PACKS
    print(f"pack cache: {cache.misses} misses, {cache.hits} hits")


if __name__ == "__main__":
    main()
