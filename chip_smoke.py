#!/usr/bin/env python3
"""Drive nnc_tpu_torch's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases:
  1. environment: the card, torch/CUDA versions, and the kernel build
     (nvcc, sm_90a) from the sources in this checkout;
  2. kernel K-B3 (posenc + MLP from points) against its plain PyTorch
     version, full-width 8x256 net with LSA scales, 262,144 points;
  3. kernel K-B2 (fused render pass) against its plain version, 4,096 rays
     at S=64 (with weights) and S=192 (without), early termination off and
     at 1e-4, with dead ray tiles;
  4. the slice at lego's geometry (400x400, near 2, far 6, white background,
     64+128 samples, N_rand 1024) on a solid full-width teacher:
     compress_model(ioq=True, lsa=False) with the render probe -> decode ->
     test-view render through the kernels and through the plain path;
  5. the LLFF-style path (NDC, raw_noise_std=1, 378x504, 64+64 samples),
     whose deterministic renders run K-B3.
The launch counts are reset just before phase 4 and read after phase 5.
Every failed check raises. The last two lines are the kernel table and the
result as JSON. Writes its files under build/chip_smoke/.
"""
import json
import math
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

import nnc_tpu_torch
from nnc_tpu.utils import ckpt
from nnc_tpu_torch.data import synthetic
from nnc_tpu_torch.models import nerf
from nnc_tpu_torch.ops import _build, mlp_fused, render_fused
from nnc_tpu_torch.render import renderer
from nnc_tpu_torch.render.rays import get_rays_np
from nnc_tpu_torch.train import presets
from nnc_tpu_torch.utils.device import require_cuda

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "chip_smoke")
# lego at half resolution: 400x400, camera_angle_x 0.6911112070083618
LEGO_HW = 400
LEGO_FOCAL = 0.5 * LEGO_HW / math.tan(0.5 * 0.6911112070083618)
FERN_HW = (378, 504)   # fern at factor 8
N_POINTS = 262_144     # K-B3 comparison
N_RAYS = 4096          # K-B2 comparison
KERNEL_ROWS = {
    "render_pass": ("nnc_tpu_torch/ops/csrc/render_pass.cu",
                    "nnc_tpu/ops/render_pallas.py:169"),
    "mlp_from_points": ("nnc_tpu_torch/ops/csrc/mlp_from_points.cu",
                        "nnc_tpu/ops/mlp_pallas.py:280"),
}


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, iters=5, warmup=2):
    """Mean milliseconds of fn() over iters launches, after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def maxabs(a, b):
    return float((a - b).abs().max())


def phase_environment():
    dev = require_cuda()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()} nvcc {_build._nvcc()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seconds = _build.build(force=True)
    _build.lib()
    print(f"[1] kernels built in {seconds:.1f} s -> {_build.LIB_PATH}")
    with open(_build.BUILD_LOG) as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("    ptxas:", line.strip())
    return dev, card


def phase_mlp(dev):
    g = torch.Generator().manual_seed(0)
    model = nerf.init_params(nerf.NeRFConfig(), g)
    model = synthetic._activate(model, g)
    model = nerf.init_lsa_scales(model, std=0.05, generator=g).to(dev)
    n = N_POINTS
    pts = (4 * torch.rand(n, 3, generator=g) - 2).to(dev)
    vd = torch.randn(n, 3, generator=g)
    vd = (vd / torch.linalg.norm(vd, dim=-1, keepdim=True)).to(dev)
    packed = mlp_fused.pack_weights(model)
    got = mlp_fused.mlp_from_points(packed, pts, vd)
    torch.cuda.synchronize()
    want = mlp_fused.fused_nerf_mlp_from_points_plain(packed, pts, vd)
    err = maxabs(got, want)
    act = lambda r: torch.cat([torch.sigmoid(r[:, :3]),
                               torch.relu(r[:, 3:])], -1)
    err_act = maxabs(act(got), act(want))
    check(torch.isfinite(got).all().item(), "K-B3 output not finite")
    check(err <= 1e-3, f"K-B3 max |draw| {err} > 1e-3")
    check(err_act <= 1e-4, f"K-B3 max |d activated| {err_act} > 1e-4")
    ms = cuda_ms(lambda: mlp_fused.mlp_from_points(packed, pts, vd))
    plain_ms = cuda_ms(
        lambda: mlp_fused.fused_nerf_mlp_from_points_plain(packed, pts, vd))
    gflop = 2 * mlp_fused.PARAMS_SIZE * n / 1e9
    print(f"[2] K-B3 {n} points: max|draw| {err:.3e} (activated "
          f"{err_act:.3e}); kernel {ms:.3f} ms ({gflop / ms:.2f} TFLOP/s), "
          f"plain {plain_ms:.3f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_render(dev):
    g = torch.Generator().manual_seed(1)
    model = synthetic.make_solid_mlp(noise_std=1e-2, generator=g, device=dev)
    packed = mlp_fused.pack_weights(model)
    R = N_RAYS
    c = LEGO_HW / 2
    K = np.array([[LEGO_FOCAL, 0, c], [0, LEGO_FOCAL, c], [0, 0, 1]],
                 np.float32)
    pose = synthetic.look_at_poses(1, radius=4.0)[0]
    ro, rd = (torch.as_tensor(a.reshape(-1, 3), device=dev)
              for a in get_rays_np(LEGO_HW, LEGO_HW, K, pose[:3, :4]))
    sel = torch.randperm(ro.shape[0], generator=g)[:R].to(dev)
    ro, rd = ro[sel].contiguous(), rd[sel].contiguous()
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    live = ((torch.arange(R, device=dev) // 64) % 4 != 3).to(torch.int32)
    worst, timing = 0.0, None
    for S, want_w in ((64, True), (192, False)):
        z, _ = torch.sort(2 + 4 * torch.rand(R, S, generator=g), dim=-1)
        z = z.to(dev)
        dists = torch.cat([z[:, 1:] - z[:, :-1],
                           torch.full_like(z[:, :1], 1e10)], -1) \
            * torch.linalg.norm(rd, dim=-1, keepdim=True)
        for eps in (0.0, 1e-4):
            term = -math.log(eps) if eps > 0 else math.inf
            args = (packed, ro, rd, vd, z, dists, live, term, want_w)
            maps, w = render_fused.render_pass(*args)
            torch.cuda.synchronize()
            maps_p, w_p = render_fused.fused_render_pass_plain(*args)
            d_rgb_acc = maxabs(maps[:, :4], maps_p[:, :4])
            d_depth = maxabs(maps[:, 4], maps_p[:, 4])
            d_w = maxabs(w, w_p) if want_w else 0.0
            tol = 1e-4 if eps == 0 else 2 * eps
            tol_depth = 1e-3 if eps == 0 else 2 * eps * 6.0
            check(torch.isfinite(maps).all().item(), "K-B2 maps not finite")
            check(d_rgb_acc <= tol and d_w <= tol and d_depth <= tol_depth,
                  f"K-B2 S={S} eps={eps}: rgb/acc {d_rgb_acc}, depth "
                  f"{d_depth}, weights {d_w}")
            check(float(maps[live == 0].abs().max()) == 0.0,
                  "K-B2 dead tiles not zero")
            if eps == 0:
                worst = max(worst, d_rgb_acc, d_w)
            ms = cuda_ms(lambda: render_fused.render_pass(*args))
            plain_ms = cuda_ms(
                lambda: render_fused.fused_render_pass_plain(*args))
            print(f"[3] K-B2 {R} rays S={S} weights={want_w} eps={eps}: "
                  f"max|d| rgb/acc {d_rgb_acc:.3e} depth {d_depth:.3e} "
                  f"weights {d_w:.3e}; kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms")
            if S == 192 and eps > 0:
                timing = (ms, plain_ms)
    return {"max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1]}


def phase_slice(dev):
    t0 = time.perf_counter()
    g = torch.Generator().manual_seed(2)
    teacher_c = synthetic.make_solid_mlp(noise_std=1e-2, generator=g,
                                         device=dev)
    teacher_f = synthetic.make_solid_mlp(noise_std=1e-2, generator=g,
                                         device=dev)
    rc_gt = renderer.RenderConfig(n_samples=64, n_importance=128,
                                  white_bkgd=True)
    scene, _ = synthetic.make_scene(
        n_images=4, H=LEGO_HW, W=LEGO_HW, rc=rc_gt, near=2.0, far=6.0,
        teachers=(teacher_c, teacher_f), focal=LEGO_FOCAL, device=dev)
    scene.update(n_importance=128, raw_noise_std=0.0,
                 dataset_type="synthetic_lego")
    torch.cuda.synchronize()
    t_gt = time.perf_counter() - t0
    check(np.isfinite(scene["images"]).all(), "ground truth not finite")

    sd = nerf.params_to_state_dict(teacher_c, "model.")
    sd.update(nerf.params_to_state_dict(teacher_f, "model_fine."))
    tar = os.path.join(OUT, "teacher.tar")
    ckpt.wrapper_dict_to_nerf_tar(sd, tar)
    bs = os.path.join(OUT, "teacher.nnc")
    pt = os.path.join(OUT, "decoded.pt")

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    nnc_tpu_torch.compress_model(tar, bitstream_path=bs, qp=-20, lsa=False,
                                 ioq=True, scene=scene, use_fused_mlp=True,
                                 device=dev, verbose=False)
    torch.cuda.synchronize()
    t_compress = time.perf_counter() - t0
    ioq_launches = _build.launch_counts()
    t0 = time.perf_counter()
    dec = nnc_tpu_torch.decompress_model(bs, model_path=pt, verbose=False)
    ckpt.convert_nerfwrapper_to_nerf_ckpt(pt, os.path.join(OUT, "decoded.tar"))
    t_decode = time.perf_counter() - t0
    check(set(dec) == set(sd), "decoded tensors differ from the input's")

    ex_k = presets.create_nerf_model_executer(scene=scene, device=dev,
                                              use_fused_mlp=True,
                                              verbose=False)
    t0 = time.perf_counter()
    psnr_k = ex_k.test_model(dec)
    torch.cuda.synchronize()
    t_test_k = time.perf_counter() - t0
    after_k = _build.launch_counts()
    ex_p = presets.create_nerf_model_executer(scene=scene, device=dev,
                                              use_fused_mlp=False,
                                              verbose=False)
    t0 = time.perf_counter()
    psnr_p = ex_p.test_model(dec)
    torch.cuda.synchronize()
    t_test_p = time.perf_counter() - t0
    check(_build.launch_counts() == after_k,
          "the plain path launched a kernel")
    teacher_k = ex_k.test_model(sd)

    size = os.path.getsize(bs)
    raw = sum(np.asarray(v).nbytes for v in sd.values())
    print(f"[4] lego-geometry slice {LEGO_HW}x{LEGO_HW}: {size} B of {raw} B "
          f"({100.0 * size / raw:.2f}%); decoded test PSNR kernels "
          f"{psnr_k:.4f} dB, plain {psnr_p:.4f} dB, diff "
          f"{psnr_k - psnr_p:+.4f} dB; teacher through kernels "
          f"{teacher_k:.2f} dB")
    print(f"    launches during IOQ {ioq_launches}, after test_model "
          f"{after_k}")
    print(f"    times: ground truth {t_gt:.1f} s, compress (IOQ) "
          f"{t_compress:.1f} s, decode {t_decode:.2f} s, test_model "
          f"kernels {t_test_k:.2f} s, plain {t_test_p:.2f} s")
    check(all(np.isfinite([psnr_k, psnr_p, teacher_k])), "PSNR not finite")
    check(abs(psnr_k - psnr_p) <= 0.05,
          f"kernel vs plain test PSNR differ by {psnr_k - psnr_p} dB")
    check(teacher_k > 40.0, f"teacher re-render through kernels only "
          f"{teacher_k} dB against its plain ground truth")
    check(psnr_k > 20.0, f"decoded model test PSNR {psnr_k} dB")
    check(ioq_launches["render_pass"] > 0, "IOQ probe ran no K-B2")


def phase_llff(dev):
    g = torch.Generator().manual_seed(3)
    teachers = tuple(synthetic.make_solid_mlp(radius=0.8, noise_std=1e-2,
                                              generator=g, device=dev)
                     for _ in range(2))
    rc_gt = renderer.RenderConfig(n_samples=64, n_importance=64,
                                  raw_noise_std=1.0)
    scene, _ = synthetic.make_scene_ndc(n_images=2, H=FERN_HW[0],
                                        W=FERN_HW[1], rc=rc_gt,
                                        teachers=teachers, device=dev)
    scene.update(n_importance=64)
    sd = nerf.params_to_state_dict(teachers[0], "model.")
    sd.update(nerf.params_to_state_dict(teachers[1], "model_fine."))
    ex = presets.create_nerf_model_executer(scene=scene, device=dev,
                                            use_fused_mlp=True, verbose=False)
    check(ex.rc.raw_noise_std == 1.0, "LLFF preset lost raw_noise_std")
    before = _build.launch_counts()["mlp_from_points"]
    t0 = time.perf_counter()
    psnr = ex.test_model(sd)
    torch.cuda.synchronize()
    t_test = time.perf_counter() - t0
    launched = _build.launch_counts()["mlp_from_points"] - before
    print(f"[5] LLFF-style NDC {FERN_HW[0]}x{FERN_HW[1]}, 64+64: teacher "
          f"test PSNR through K-B3 {psnr:.2f} dB in {t_test:.2f} s, "
          f"{launched} K-B3 launches")
    check(np.isfinite(psnr) and psnr > 40.0,
          f"NDC render through K-B3 {psnr} dB against its plain ground truth")
    check(launched > 0, "the LLFF-style path ran no K-B3")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    t_start = time.perf_counter()
    dev, card = phase_environment()
    rows = {"mlp_from_points": phase_mlp(dev),
            "render_pass": phase_render(dev)}
    phase_slice(dev)          # resets the launch counts first
    phase_llff(dev)
    launches = _build.launch_counts()
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    kernels = [{"name": name, "route": "cuda",
                "source": KERNEL_ROWS[name][0],
                "replaces": KERNEL_ROWS[name][1],
                "launches": launches[name],
                "max_abs_err": rows[name]["max_abs_err"],
                "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"]}
               for name in ("render_pass", "mlp_from_points")]
    print(f"total {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
