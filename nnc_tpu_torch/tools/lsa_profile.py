"""Where an LSA step's time goes on the card: wall, device-busy and idle share
of the step through K-B1 and through the plain MLP. Needs a CUDA device and
nvcc:

    python -m nnc_tpu_torch.tools.lsa_profile [--dtype bfloat16]

``--dtype bfloat16`` tunes models built with
``NeRFConfig(compute_dtype=torch.bfloat16)``: K-B1's bf16 kernels, and the
plain bf16 MLP (the scale folded into the weight before rounding).

The scene is lego's geometry (400 x 400, focal 555.6, near 2, far 6, white
background, 64 + 128 samples, N_rand 1,024) on a solid full-width teacher;
the tuned models are the teacher with 5% noise on every weight. After the
card's name and power limit it prints, for the two paths in turns (kernels,
plain, plain, kernels):
  * the mean step on the host clock over STEPS steps that end in a
    synchronize, without the profiler;
  * the same under ``torch.profiler``, the device time of all kernels in
    that window per step (device busy), the idle share 1 - busy / wall of
    the profiled window, K-B1's share of the device time, the number of
    device events a step, and the launches of K-B1 in the window;
  * the hits and misses of the weights' pack cache over the kernel runs
    (an LSA run packs each model's weights once).
"""
from __future__ import annotations

import argparse
import math
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from ..data import synthetic
from ..models import nerf
from ..ops import _build, mlp_train_fused
from ..render import renderer
from ..train import lsa, presets

HW = 400
FOCAL = 0.5 * HW / math.tan(0.5 * 0.6911112070083618)
STEPS = 10
WARMUP = 3
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


def _steps(ex, models, n):
    """n LSA steps on the executer's batches; the mean step in ms on the
    host clock, ending in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lsa.tune_lsa_scales(*models, ex._make_batcher(), ex.rc, ex.scene["near"],
                        ex.scene["far"], learning_rate=LR,
                        learning_rate_decay=0.0, epochs=1, n_iters=n,
                        verbose=False)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / n


def _device_time(evt):
    """Microseconds on the device of a key_averages() entry that stands for
    device work (a kernel, a memcpy, a memset). The entries of host
    operators carry the time of the kernels launched inside them as well,
    and count for nothing here."""
    if evt.device_type != DeviceType.CUDA:
        return 0.0
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return getattr(evt, attr)
    return 0.0


def run(dev, scene, sd, fused, mlp):
    ex = presets.create_nerf_model_executer(scene=scene, device=dev,
                                            use_fused_mlp=fused,
                                            mlp_config=mlp,
                                            learning_rate=LR, verbose=False)
    models = ex._split_params(sd)
    _steps(ex, models, WARMUP)
    wall = _steps(ex, models, STEPS)
    before = _build.launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof = _steps(ex, models, STEPS)
    after = _build.launch_counts()
    events = [e for e in prof.key_averages() if _device_time(e) > 0]
    busy = sum(_device_time(e) for e in events) / 1e3 / STEPS
    kb1 = sum(_device_time(e) for e in events
              if "mlp_train" in e.key) / 1e3 / STEPS
    count = sum(e.count for e in events) / STEPS
    launches = {k: after[k] - before[k] for k in after
                if k.startswith("mlp_train")}
    tag = "" if mlp.compute_dtype == torch.float32 else " bf16"
    print(f"LSA step, {'K-B1' if fused else 'plain'}{tag}: {wall:.3f} ms wall "
          f"({wall_prof:.3f} ms under the profiler); device busy "
          f"{busy:.3f} ms a step, idle share "
          f"{100 * (1 - busy / wall_prof):.1f}% of the profiled step "
          f"({100 * (1 - busy / wall):.1f}% of the unprofiled one); K-B1 "
          f"{kb1:.3f} ms = {100 * kb1 / busy:.1f}% of the device time; "
          f"{count:.0f} device events a step; launches in the window "
          f"{launches}")
    top = sorted(events, key=_device_time, reverse=True)[:5]
    print("    most device time: " + "; ".join(
        f"{e.key[:48]} {_device_time(e) / 1e3 / STEPS:.3f} ms x "
        f"{e.count / STEPS:.0f}" for e in top))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=("float32", "bfloat16"),
                    default="float32")
    mlp = nerf.NeRFConfig(compute_dtype=getattr(
        torch, ap.parse_args(argv).dtype))
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.lib()
    scene, sd = _scene(dev)
    # a checkout from before the pack cache has none: the tool runs on a
    # parent commit too, for a before and after in one call
    cache = getattr(mlp_train_fused, "TRAIN_PACKS", None)
    for fused in (True, False, False, True):
        run(dev, scene, sd, fused, mlp)
    if cache is not None:
        print(f"pack cache over two runs of {WARMUP + 2 * STEPS} kernel "
              f"steps, two models a step, new models in each run: "
              f"{cache.misses} misses, {cache.hits} hits")


if __name__ == "__main__":
    main()
