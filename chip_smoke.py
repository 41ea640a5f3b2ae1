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
     whose deterministic renders run K-B3;
  6. kernel pair K-B1 (training MLP forward + backward) against its plain
     versions at the LSA step's shapes, 65,536 (coarse) and 196,608 (fine)
     points, full width, LSA scales std 0.05, with_dw off and on, timed
     against the plain forward + torch autograd backward;
  7. the LSA slice on phase 4's scene and teacher: compress_model(qp=-20,
     lsa=True) tuning the scales through K-B1 -> decode -> test render,
     beside the same qp without LSA, and a 10-step kernel-vs-plain LSA
     trajectory with the same batches and draws.
The launch counts are reset just before phase 4 and read after phase 5 (the
render path), and reset just before phase 7 and read after it (the LSA
path). Every failed check raises. The last two lines are the kernel table
and the result as JSON. Writes its files under build/chip_smoke/.
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
from nnc_tpu.utils.logging import read_result_file
from nnc_tpu_torch.data import synthetic
from nnc_tpu_torch.models import nerf
from nnc_tpu import coder
from nnc_tpu_torch.ops import _build, mlp_fused, mlp_train_fused, render_fused
from nnc_tpu_torch.ops.posenc import positional_encoding
from nnc_tpu_torch.render import renderer
from nnc_tpu_torch.render.rays import get_rays_np
from nnc_tpu_torch.train import lsa, presets
from nnc_tpu_torch.utils.device import require_cuda

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "chip_smoke")
# lego at half resolution: 400x400, camera_angle_x 0.6911112070083618
LEGO_HW = 400
LEGO_FOCAL = 0.5 * LEGO_HW / math.tan(0.5 * 0.6911112070083618)
FERN_HW = (378, 504)   # fern at factor 8
N_POINTS = 262_144     # K-B3 comparison
N_RAYS = 4096          # K-B2 comparison
N_TRAIN = (65_536, 196_608)   # K-B1: one LSA step's coarse and fine points
TRAJ_STEPS = 10
# LSA learning rate of phase 7: 1e-3, so that 40 steps move scales past half
# a quantization step of the bitstream's scales (2^-7 at their qp of -28);
# the CLI default 1e-4 moves them at most 4e-3 in 40 steps
LSA_LR = 1e-3
KERNEL_ROWS = {
    "render_pass": ("nnc_tpu_torch/ops/csrc/render_pass.cu",
                    "nnc_tpu/ops/render_pallas.py:169"),
    "mlp_from_points": ("nnc_tpu_torch/ops/csrc/mlp_from_points.cu",
                        "nnc_tpu/ops/mlp_pallas.py:280"),
    "mlp_train_fwd": ("nnc_tpu_torch/ops/csrc/mlp_train.cu",
                      "nnc_tpu/ops/mlp_train_pallas.py:275"),
    "mlp_train_bwd": ("nnc_tpu_torch/ops/csrc/mlp_train.cu",
                      "nnc_tpu/ops/mlp_train_pallas.py:300"),
}
RENDER_KERNELS = ("render_pass", "mlp_from_points")
LSA_KERNELS = ("mlp_train_fwd", "mlp_train_bwd")


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
    return scene, sd, tar


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


def grad_errors(got, want):
    """The largest max |d| / max |want| over the gradients, the largest max
    |d|, and whether every gradient meets tests/test_mlp_train_pallas.py:
    41-50 (99.9% of elements within rtol 5e-2 / atol 5e-3 of the scale, none
    off by 5% of it)."""
    worst, worst_abs, ok = 0.0, 0.0, True
    for part_g, part_w in zip(got, want):
        if part_g is None:
            continue
        for name in part_w:
            g, w = part_g[name], part_w[name]
            scale = max(float(w.abs().max()), 1e-12)
            d = float((g - w).abs().max())
            close = torch.isclose(g, w, rtol=5e-2, atol=5e-3 * scale)
            ok = ok and float(close.float().mean()) > 0.999 and \
                d < 0.05 * scale
            worst, worst_abs = max(worst, d / scale), max(worst_abs, d)
    return worst, worst_abs, ok


def phase_train_kernels(dev):
    g = torch.Generator().manual_seed(4)
    model = nerf.init_params(nerf.NeRFConfig(), g)
    model = synthetic._activate(model, g)
    model = nerf.init_lsa_scales(model, std=0.05, generator=g).to(dev)
    tensors = mlp_train_fused._layer_tensors(model)
    params, params_t, ls = mlp_train_fused.pack_train(
        tensors[0::3], tensors[1::3], tensors[2::3])
    row = None
    for n in N_TRAIN:
        pts = (4 * torch.rand(n, 3, generator=g) - 2).to(dev)
        vd = torch.randn(n, 3, generator=g)
        vd = (vd / torch.linalg.norm(vd, dim=-1, keepdim=True)).to(dev)
        cot = (1e-3 * torch.randn(n, 4, generator=g)).to(dev)
        raw, ws = mlp_train_fused.mlp_train_fwd(params, ls, pts, vd,
                                                save_u=True)
        torch.cuda.synchronize()
        raw_p = mlp_train_fused.mlp_train_fwd_plain(params, ls, pts, vd)
        err_raw = maxabs(raw, raw_p)
        check(torch.isfinite(raw).all().item(), "K-B1 forward not finite")
        check(err_raw <= 1e-3, f"K-B1 forward max |draw| {err_raw} > 1e-3")
        fwd_ms = cuda_ms(lambda: mlp_train_fused.mlp_train_fwd(
            params, ls, pts, vd, save_u=True))
        pe, ve = positional_encoding(pts, 10), positional_encoding(vd, 4)
        for with_dw in (False, True):
            flat = mlp_train_fused.mlp_train_bwd(params, params_t, ls, pts,
                                                 vd, cot, ws, with_dw)
            torch.cuda.synchronize()
            flat_p = mlp_train_fused.mlp_train_bwd_plain(
                params, params_t, ls, pts, vd, cot, with_dw)
            err_g, err_g_abs, ok = grad_errors(
                mlp_train_fused.split_grads(flat, with_dw),
                mlp_train_fused.split_grads(flat_p, with_dw))
            check(torch.isfinite(flat).all().item(), "K-B1 grads not finite")
            check(ok, f"K-B1 backward n={n} with_dw={with_dw}: gradients "
                  f"off the plain version's (worst {err_g:.3e} of scale)")
            again = mlp_train_fused.mlp_train_bwd(params, params_t, ls, pts,
                                                  vd, cot, ws, with_dw)
            check(torch.equal(again, flat), "K-B1 backward not deterministic")
            bwd_ms = cuda_ms(lambda: mlp_train_fused.mlp_train_bwd(
                params, params_t, ls, pts, vd, cot, ws, with_dw))

            # plain: the output-scaling MLP, torch autograd for its backward
            for layer in model.layers().values():
                layer.weight.requires_grad_(with_dw)
                layer.bias.requires_grad_(True)
                layer.weight_scaling.requires_grad_(True)

            def plain_fwd():
                return nerf.apply_mlp(model, pe, ve, output_scaling=True)

            def plain_fwd_bwd():
                plain_fwd().backward(cot)

            plain_fwd_ms = cuda_ms(lambda: plain_fwd().detach())
            plain_bwd_ms = cuda_ms(plain_fwd_bwd) - plain_fwd_ms
            for layer in model.layers().values():
                for t in (layer.weight, layer.bias, layer.weight_scaling):
                    t.requires_grad_(False)
                    t.grad = None
            print(f"[6] K-B1 {n} points with_dw={with_dw}: max|draw| "
                  f"{err_raw:.3e}, worst gradient error {err_g:.3e} of its "
                  f"max ({err_g_abs:.3e} absolute); kernel fwd "
                  f"{fwd_ms:.3f} ms + bwd {bwd_ms:.3f} ms, "
                  f"plain fwd {plain_fwd_ms:.3f} ms + autograd bwd "
                  f"{plain_bwd_ms:.3f} ms")
            if n == N_TRAIN[-1] and not with_dw:
                row = {"mlp_train_fwd": {"max_abs_err": err_raw,
                                         "ms": fwd_ms,
                                         "plain_ms": plain_fwd_ms},
                       "mlp_train_bwd": {"max_abs_err": err_g_abs,
                                         "ms": bwd_ms,
                                         "plain_ms": plain_bwd_ms}}
        del ws
    return row


def _lsa_run(ex, model_c, model_f, draws):
    """TRAJ_STEPS LSA steps from the given models on the executer's batches
    and the given draws; returns (scales {name: (out,)} of both models,
    mean step ms on the host clock)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ls_c, ls_f, *_ = lsa.tune_lsa_scales(
        model_c, model_f, ex._make_batcher(), ex.rc, ex.scene["near"],
        ex.scene["far"], learning_rate=ex.learning_rate,
        learning_rate_decay=0.0, epochs=1, n_iters=TRAJ_STEPS,
        verbose=False, draws=draws)
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / TRAJ_STEPS
    return torch.cat([torch.cat(list(d.values())) for d in (ls_c, ls_f)]), ms


def phase_lsa(dev, scene, sd, tar):
    lsa_dir = os.path.join(OUT, "lsa")
    bs = os.path.join(lsa_dir, "bitstream", "lego_lsa.nnc")
    os.makedirs(os.path.dirname(bs))
    kw = dict(qp=-20, ioq=False, scene=scene, use_fused_mlp=True,
              learning_rate=LSA_LR, device=dev, verbose=False)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    nnc_tpu_torch.compress_model(tar, bitstream_path=bs, lsa=True,
                                 N_iters=20, epochs=2, i_save=20,
                                 render_factor=4, **kw)
    torch.cuda.synchronize()
    t_compress = time.perf_counter() - t0
    dec = nnc_tpu_torch.decompress_model(bs, verbose=False)
    ex = presets.create_nerf_model_executer(scene=scene, device=dev,
                                            use_fused_mlp=True,
                                            learning_rate=LSA_LR,
                                            verbose=False)
    psnr_lsa = ex.test_model(dec)
    torch.cuda.synchronize()
    launches = {k: _build.launch_counts()[k] for k in LSA_KERNELS}

    _psnrs, loss_log = read_result_file(os.path.join(lsa_dir, "result.txt"))
    with open(bs, "rb") as f:
        _info, approx = coder.decode(f.read())
    n_scales = sum(k.endswith(".weight_scaling")
                   for k in approx["parameters"])
    check(launches["mlp_train_fwd"] > 0 and launches["mlp_train_bwd"] > 0,
          f"LSA tuning ran no K-B1: {launches}")
    check(len(loss_log) == 40 and np.isfinite(loss_log).all(),
          f"LSA losses: {len(loss_log)} logged, finite "
          f"{np.isfinite(loss_log).all()}")
    check(n_scales == 24, f"{n_scales} scale vectors in the bitstream")
    check(set(dec) == set(sd), "decoded tensors differ from the input's")
    check(os.path.exists(os.path.join(lsa_dir, "reconstructed",
                                      "ckpt_step40.pt")) and
          os.path.exists(os.path.join(lsa_dir, "testset_step20", "003.png")),
          "i_save checkpoint or test PNG missing")

    bs0 = os.path.join(OUT, "lego_nolsa.nnc")
    nnc_tpu_torch.compress_model(tar, bitstream_path=bs0, lsa=False, **kw)
    dec0 = nnc_tpu_torch.decompress_model(bs0, verbose=False)
    psnr_nolsa = ex.test_model(dec0)
    check(np.isfinite([psnr_lsa, psnr_nolsa]).all(), "PSNR not finite")
    # the decode folds the scales into the weights: tuned scales other
    # than 1 make them differ from the same qp's decode without LSA
    moved = max(float(np.abs(dec[k] - dec0[k]).max()) for k in dec0)
    check(moved > 0.0, "the tuned scales did not move from 1")

    # 10 LSA steps from the no-LSA decode, through K-B1 and through the
    # plain MLP, on the same batches and draws
    g = torch.Generator(device=dev).manual_seed(5)
    n_rand, rc = min(ex.n_rand, scene["H"] * scene["W"]), ex.rc
    sets = [{"t_rand": torch.rand(n_rand, rc.n_samples, generator=g,
                                  device=dev),
             "u": torch.rand(n_rand, rc.n_importance, generator=g,
                             device=dev)} for _ in range(TRAJ_STEPS)]
    draws = lambda i: sets[i]
    ls_k, ms_k = _lsa_run(ex, *ex._split_params(dec0), draws)
    before = _build.launch_counts()
    ex_p = presets.create_nerf_model_executer(scene=scene, device=dev,
                                              use_fused_mlp=False,
                                              learning_rate=LSA_LR,
                                              verbose=False)
    ls_p, ms_p = _lsa_run(ex_p, *ex_p._split_params(dec0), draws)
    check(_build.launch_counts() == before, "the plain LSA run launched a "
          "kernel")
    drift = float((ls_k - ls_p).abs().max())
    span = float((ls_p - 1.0).abs().max())
    drift_l2 = float(torch.linalg.norm(ls_k - ls_p)
                     / torch.linalg.norm(ls_p - 1.0))
    print(f"[7] LSA slice {LEGO_HW}x{LEGO_HW}, 64+128, N_rand 1024: "
          f"compress(lsa, 40 steps, 3 i_saves) {t_compress:.1f} s; test "
          f"PSNR with LSA {psnr_lsa:.4f} dB, without {psnr_nolsa:.4f} dB at "
          f"qp=-20; loss {loss_log[0]:.3e} -> {loss_log[-1]:.3e}; decoded "
          f"weights moved by the scales up to {moved:.3e}; launches "
          f"{launches}")
    print(f"    {TRAJ_STEPS}-step trajectory: mean LSA step {ms_k:.2f} ms "
          f"through K-B1, {ms_p:.2f} ms plain; |d(ls-1)| max {drift:.3e} of "
          f"max|ls-1| {span:.3e}, L2 {drift_l2:.3e} of |ls-1|")
    # Adam moves each scale by about lr per step whatever its gradient's
    # size, so float32 reassociation in the gradient sums (relative ~1e-6)
    # moves the two trajectories apart by far less than 1% of how far they
    # go, and a wrong gradient term by O(1) of it, in every channel it
    # touches. A channel whose gradient sits near Adam's eps (1e-8) is the
    # exception: its update follows the gradient's absolute error and can
    # move by ~20% of a step (two plain implementations on the CPU with 64
    # rays: 1 of 4,872 channels, max ratio 2.2e-2). Both the max over the
    # 4,872 scales and their L2 norm are held to 1e-2 of the plain run's
    # motion; the L2 bound is the one that a single such channel leaves
    # meaningful.
    check(span > 0.0 and drift <= 1e-2 * span and drift_l2 <= 1e-2,
          f"K-B1 LSA trajectory drifts from the plain one: max {drift} "
          f"(bound 1e-2 x {span}), L2 {drift_l2} (bound 1e-2)")
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    t_start = time.perf_counter()
    dev, card = phase_environment()
    rows = {"mlp_from_points": phase_mlp(dev),
            "render_pass": phase_render(dev)}
    scene, sd, tar = phase_slice(dev)   # resets the launch counts first
    phase_llff(dev)
    launches = {k: _build.launch_counts()[k] for k in RENDER_KERNELS}
    rows.update(phase_train_kernels(dev))
    launches.update(phase_lsa(dev, scene, sd, tar))   # resets them first
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    kernels = [{"name": name, "route": "cuda",
                "source": KERNEL_ROWS[name][0],
                "replaces": KERNEL_ROWS[name][1],
                "launches": launches[name],
                "max_abs_err": rows[name]["max_abs_err"],
                "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"]}
               for name in KERNEL_ROWS]
    print(f"total {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
