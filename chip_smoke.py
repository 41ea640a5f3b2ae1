#!/usr/bin/env python3
"""Drive nnc_tpu_torch's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases:
  1. environment: the card, torch/CUDA versions, and the kernel build
     (nvcc, sm_90a) from the sources in this checkout, with the codec's
     CABAC library (g++) built beside it;
  2. kernel K-B3 (posenc + MLP from points, 3xTF32 products on the tensor
     cores) against its exact float32 plain PyTorch version, full-width
     8x256 net with LSA scales, 262,144 points and three ragged sizes, reruns
     bit-equal; timed in turns with the plain version, beside the SIMT
     kernel it replaced (its time from PERF.md);
  3. kernel K-B2 (fused render pass, the same chain) against its plain
     version, 4,096 rays at S=64 (with weights) and S=192 (without), early
     termination off and at 1e-4, with dead ray tiles, reruns bit-equal;
  4. the slice at lego's geometry (400x400, near 2, far 6, white background,
     64+128 samples, N_rand 1024) on a solid full-width teacher:
     compress_model(ioq=True, lsa=False) with the render probe -> decode ->
     test-view render through the kernels and through the plain path; the
     same compression with the probe on the plain path, for its bytes;
  5. the LLFF-style path (NDC, raw_noise_std=1, 378x504, 64+64 samples),
     whose deterministic renders run K-B3, beside the plain path;
  6. kernel pair K-B1 (training MLP forward + backward, 3xTF32 products on
     the tensor cores; with dW the backward writes every du to a workspace
     and a GEMM over the points sums dW) against its plain versions at the
     LSA step's shapes, 65,536 (coarse) and 196,608 (fine) points, full
     width, LSA scales std 0.05, with_dw off and on, reruns bit-equal, timed
     against the plain forward + torch autograd backward, with dW beside the
     SIMT kernel it replaced (its time from PERF.md);
  7. the LSA slice on phase 4's scene and teacher: compress_model(qp=-20,
     lsa=True) tuning the scales through K-B1 -> decode -> test render,
     beside the same qp without LSA, and a 10-step kernel-vs-plain LSA
     trajectory with the same batches and draws;
  8. kernel K-B5 (MLP on embeddings made outside, K-B3's 3xTF32 chain)
     against its exact float32 plain version and the plain model of the
     3xTF32 arithmetic, phase 2's net and points embedded by torch and three
     ragged sizes, and against K-B3; reruns bit-equal, HMMA in its SASS,
     timed beside K-B3, the plain version and the SIMT kernel it replaced
     (from PERF.md);
  9. kernel K-B4 (int8 MLP from points, s8 mma.sync products on the tensor
     cores) against its plain version at INT8_ACT_BLOCK points per
     activation scale, and against the float MLP under the reference's
     bound, same net and points, reruns bit-equal, IMMA and no IDP.4A in its
     SASS, timed beside the __dp4a kernel it replaced (from PERF.md);
 10. the low-precision slice on phase 5's scene: test_model with
     use_int8_mlp (K-B4) on the teacher, a test view of random full-width
     models through K-B4 against the float render of the same models, and
     test_model with the MLP called as fused_nerf_mlp on embeddings made as
     the renderer makes them (K-B5) against the K-B3 render. Then one more
     view through each of K-B3, K-B4 and K-B5 in which every launch is held
     against the plain version on the tensors the renderer gave it (chunks
     of 32,768 rays and the ragged last one, 64 and 128 samples: 1.7M to
     4.2M points), and the K-B4 view against the same view rendered through
     the plain int8 version.
 11. kernel K-B6 (one shard's column + row pair of the tensor-parallel MLP,
     3xTF32 products on the tensor cores) against its exact float32 plain
     version (cuBLAS) and the plain model of its 3xTF32 arithmetic at 262,144
     points: the three pair shapes of the forward at M = 4 shards, and the
     lightest and the heaviest pair at M = 1 and at M = 8; reruns
     bit-equal, HMMA in its SASS, timed beside cuBLAS and the SIMT kernel
     it replaced (from PERF.md);
 12. the tensor-parallel slice at full width: fused_nerf_mlp_tp on a mesh of
     4 x cuda:0 on the embeddings of the first launch of a 378x504 NDC view
     (32,768 rays x 64 samples), against K-B5 on the same tensors; then the
     same call with each of its 20 launches of K-B6 held against the plain
     version on the tensors the forward gave it; then one shard's five pair
     calls with the sum over shards left out, for M in 1, 2, 4, beside
     K-B5's time / M (a measurement, no verdict);
 13. the multi-device slice on meshes of 4 x cuda:0:
     graft_entry.dryrun_multichip(4); 10 data-parallel LSA steps at lego
     geometry (N_rand 1,024) against the single-device run on the same
     draws; one 400x400 test view through render_image(mesh=) against the
     view without a mesh, with culling and early termination off (equal
     bits expected) and on; a joint LSA of 2 scenes against each scene
     tuned alone;
 14. the bf16 kernels: K-B3 bf16 (warpgroup wgmma products on slabs laid
     out as shared-memory images) at 262,144 points and three ragged sizes
     and K-B2 bf16 (early termination per ray, persistent CTAs on a ray
     queue) on phase 3's rays at S=64 and S=192, early termination off and
     at 1e-4, each against its plain bf16 version in units of the distance
     between the plain bf16 and the plain float32 version on the same
     inputs, reruns bit-equal, timed beside the float32 kernel and the plain
     version; K-B3 bf16's SASS holds HGMMA and no HMMA, its time beside the
     mma.sync kernel it replaced, K-B2 bf16's points and time beside those
     of the tiles of four rays it replaced (both from PERF.md);
 15. the bf16 serving slice at full width: test_model through an executer
     built with NeRFConfig(compute_dtype=torch.bfloat16) and use_fused_mlp on
     phase 4's scene and decoded weights (K-B2 bf16, coarse and fine) against
     the float32 kernels' render and the plain bf16 render; phase 5's NDC
     scene through K-B3 bf16; compress_model(ioq=True) with the probe in
     bf16; graft_entry.entry() in bf16;
 16. kernel pair K-B1 in bf16 (forward, backward without and with dW, the
     latter's GEMM too, on the tensor cores) against its plain bf16 versions at
     phase 6's shapes, full width, LSA scales std 0.05: raw and every
     gradient in units of the distance between the plain bf16 and the plain
     float32 version on the same inputs, reruns bit-equal, the forward
     without its workspace giving the same raw, timed in turns beside
     float32 K-B1 and the plain bf16 versions, and beside the kernels they
     replaced (from PERF.md);
 17. the bf16 LSA slice on phase 4's scene and teacher:
     compress_model(qp=-20, lsa=True, mlp_config=bf16) tuning through K-B1
     bf16 -> decode -> test render through K-B2 bf16; a 10-step trajectory
     from phase 7's no-LSA decode through K-B1 bf16 against the same steps
     through its plain bf16 versions and phase 7's float32 plain run, on
     phase 7's batches and draws; nnc_tpu_torch.tools.bench_train_step at
     full width, without and with dW, and once in float32 with dW;
 18. kernels K-B5 bf16 (MLP on embeddings) and K-B6 bf16 (one shard's pair)
     against their plain bf16 versions in units of the bf16-to-float32
     distance: K-B5 bf16 on phase 2's net and points embedded by torch and
     at three ragged sizes, and against K-B3 bf16 on the same points; K-B6
     bf16 at phase 11's pair shapes; reruns bit-equal, timed beside the
     float32 kernels and the plain bf16 versions, K-B5 bf16 beside the
     kernel that loaded its embedding between two tiles' products (from
     PERF.md);
 19. the bf16 tensor-parallel slice on phase 5's NDC scene and teacher:
     fused_nerf_mlp_tp of the bf16 model on 4 x cuda:0 on phase 12's
     embeddings against K-B5 bf16 and the dense plain bf16 MLP, then each of
     its 20 launches of K-B6 bf16 held against the plain version on the
     forward's tensors; test_model through a bf16 executer with the MLP
     called as fused_nerf_mlp (phase 10's swap), K-B5 bf16 on the
     renderer's chunks, each launch of one more view held against its plain
     version, the PSNR against phase 15's K-B3 bf16 render;
     nnc_tpu_torch.tools.tp_mlp_bench in bf16;
 20. the occupancy-grid mode (render/occupancy.py), in float32 and in bf16:
     compress_model(lsa=True, occupancy_tuning=True, occupancy_renders=True)
     on phase 4's scene and teacher (20 LSA steps on the occupancy loss
     through K-B1, its i_save views through grids swept by K-B3 and frames
     through K-B2), the decode's test view and a 400x400 frame through the
     grid, timed beside the exact render; then the grid through K-B3
     against the grid through its plain version (voxels apart only at a
     threshold tie), the frame through K-B2 against the same selection
     through its plain version (phase 3's tolerances, bf16 in units of the
     bf16-to-float32 distance), each kernel timed at this mode's shapes
     (a sweep chunk of 262,144 voxel centres, 160,000 rays of 16 compacted
     samples with the points needed against those computed, in float32 the
     packed render pass beside render_pass_kernel on the same launch, their
     maps bit for bit, 1,024 rays x 32 selected samples); the reference's
     quality sweep (bench.py:145-212:
     160x256, 4 poses, res 128, 48 candidates, budget 16, subsample 4):
     devPSNR of the fast render against the exact render through the
     kernels, at least 47.0 dB on the solid teacher (the reference's 47.19),
     four fog teachers' beside the reference's 33.23 with their open
     boundary detected; an LSA step on the occupancy loss timed beside the
     exact one;
 21. the reference's multi-step LSA call on phase 7's scene, in float32 and
     in bf16, on the exact loss and on the occupancy loss (phase 20's
     tuning grid): tune_lsa_scales over 24 steps with i_save 10 at
     steps_per_call=8 (two full calls, each one replay of a CUDA graph of 8
     steps through K-B1) and at steps_per_call=1, the scales equal bit for
     bit and K-B1's launches counted with the graph's replays and its
     warm-up step; then each route timed in turns (8, 1, 1, 8) over 32
     steps by tools/lsa_profile.measure: step ms, device-busy ms and idle
     share under torch.profiler, the graph's capture s and pool MB, beside
     the card's name and power limit;
 22. the classification side and the JAX-free tools: the registry's
     NERF_PYT handler for one epoch of 16 LSA steps on phase 7's scene from
     its no-LSA decode (two CUDA-graph calls through K-B1) under
     utils/profiling.trace_if, its scales bit-equal to the direct
     tune_lsa_scales call with the reference's arguments, K-B1's launches
     2 x (16 + 1 warm-up), the trace holding the region's span and
     K-B1's kernels; a ClassificationExecuter at 3072-1024-1024-10 on 4,096
     seeded samples through compress_model(lsa, ioq, qp=-38) (decoded top1
     no more than 0.05 under the float model's) and its LSA epochs against
     the same run on the CPU; a TorchModuleExecuter on a conv net (3x32x32,
     64 / 128 / 256 channels, the last reflect-padded) through
     compress_model(lsa, fine_tune), its tuning against the CPU with
     the executer's float32 convolutions and the difference of one built
     with allow_tf32 beside it; then the port's tools as their command
     lines: demo_synthetic --full-mlp --iters 100 (LSA must gain PSNR),
     rd_sweep --synthetic at 2 qps (finite PSNR, LSA losing none),
     render_video --synthetic (4 frames, grid route), multi_scene
     --synthetic (2 scenes, 8 steps, finite PSNR) and profile_codec; the
     first K-B2 launch of each shape the tools make is held against its
     plain version;
 23. the render-side tools in float32 and in bf16, each as its command line
     at the reference's sizes with RENDER_TOOL_ITERS iterations:
     bench_render_v2 --check (a 64x128 frame of the solid teacher at 64+128
     samples through the plain, fused_mlp, fused_noet and fused_et_64x32
     routes), tune_fast_mode --floor (a 160x256 frame, its 128^3 grid through
     K-B3, the exact frame through K-B2, four operating points of the
     occupancy mode) and profile_fast_frame (the stages of a 400x400 frame,
     K-B2's own time inside it), and profile_fast_frame's stages on phase
     20's 400x400 solid frame (lego geometry); the first K-B2 and K-B3
     launch of each shape each run makes is held against the plain version
     (K-B2 as phase 22 holds it; K-B3 float32 at phase 2's bar grown with
     the raw's size; bf16 in units of the bf16-to-float32 distance, or equal
     where the plain bf16 and float32 versions agree bit for bit), and the
     tools' results are printed as the `render tools:` JSON line;
 24. the port's bench (nnc_tpu_torch/bench.py, the reference's bench.py)
     in float32 and in bf16, as its command line at the reference's sizes
     with BENCH_ARGV's cut iterations: the exact 160x256 crop, the 128^3
     grid, the fast crop and the 400x400 frame at 48 / 16 / 4, the quality
     sweep (solid, fog, turbo), the LSA step on the exact and the occupancy
     loss as single steps and in calls of 8, and the codec; each run must
     launch K-B1's forward and backward, K-B2 and K-B3 of its type and no
     other kernel; its first K-B2 and K-B3 launch of each shape is held
     against the plain versions as phase 23 holds them, and its first K-B1
     forward and backward of each shape against mlp_train_*_plain at phase
     20's bars (the launch read the teacher's own weight buffers); the
     solid devPSNR at least OCC_SOLID_MIN, the turbo point's finite and
     above BENCH_TURBO_MIN (printed beside the reference's 46.53), the
     reference's open-boundary gate (the bench raises) and every number of
     the line finite; both bench lines are printed.
 25. K-B1's IPE instantiation (mip-NeRF: the frustum's 96 IPE channels
     embedded inside the kernel) against its plain versions at a mip-NeRF
     step's 1,048,576 points and a tenth of them (forward raw within
     TOL_RAW, backward dls and db by phase 20's gradient criterion, its
     rerun bit-equal), timed in turns with the
     vanilla instantiation on as many points, each beside its share of the
     165 TFLOP/s bound; 9 steps of mip-NeRF's LSA (4,096 rays, two levels
     of 128 samples, one MLP) in calls of 8 and of 1, bit-equal, launching
     only the IPE instantiation; compress_model(lsa=True) on a 96x96
     mip-NeRF scene (17 steps, i_save 17: the test view through the IPE
     forward), decode and test_model, launching the IPE instantiation
     only; the `ipe:` JSON line.
 26. kernel K-B7 (the LSA epilogue of mip-NeRF 360's layers, each a cuBLAS
     float32 GEMM) against its plain versions at a mip-NeRF 360 step's
     shapes, 524,288 x 1,024 (a NeRF trunk layer: 16,384 rays x 32) and
     1,048,576 x 256 (a proposal layer: 16,384 x 64), ReLU layers: the
     forward and dacc within 2e-6 (+ 2e-6 relative), the scale and bias
     gradients' column sums within 1e-5 of the sum of their terms'
     magnitudes (the card tests' bars), reruns bit-equal; each direction
     timed in turns with its plain version, beside its bound by bytes and
     the layer's GEMM; then 9 LSA steps of mip-NeRF 360 at the published
     widths (1,024 rays, 64 + 64 + 32 samples) in calls of 8 and
     compress_model(lsa=True) on a 32x48 mip-NeRF 360 scene, each launching
     K-B7 only, 44 times a step (22 layers forward and backward); the
     `kb7:` JSON line.
Every LSA run of phases 7, 13, 17 and 20 takes the default steps_per_call
of 8: a run's first full call captures its graph after one warm-up step,
whose K-B1 launches count (lsa.WARMUP_STEPS).
The launch counts are reset just before each path and read just after it:
phases 4-5 (the render path), phase 7 (the LSA path), the two renders of
phase 10, the tensor-parallel call of phase 12, the runs of phase 13,
the two test_model renders and the compression of phase 15, the
compression and the three bench_train_step runs of phase 17, phase 19's
bf16 tensor-parallel call, its test_model render and its tp_mlp_bench run,
phase 20's compression, test view and frames, per type, each of phase
21's runs, phase 22's NERF_PYT epoch, demo_synthetic and render_video, and
each of phase 23's tool runs and both of phase 24's bench runs.
Every failed check raises. Each kernel's bound is the larger of
its bytes over the card's memory rate and its operations over the card's
peak for their type: for K-B1, K-B2, K-B3, K-B5 and K-B6, whose float32
products are three TF32 products each, a third of the tensor cores' TF32 peak; for the bf16 kernels the dense bf16 peak. The last two lines are the kernel table and the result
as JSON. Writes its files under build/chip_smoke/.
"""
import concurrent.futures
import contextlib
import ctypes
import dataclasses
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
from nnc_tpu_torch import bench as port_bench
from nnc_tpu_torch import coder, graft_entry, parallel
from nnc_tpu_torch.coder import cabac
from nnc_tpu_torch.data import synthetic
from nnc_tpu_torch.data.rays import RayBatcher
from nnc_tpu_torch.framework import torch_executer, use_cases
from nnc_tpu_torch.models import nerf
from nnc_tpu_torch.ops import (_build, mlp_fused, mlp_tp_fused,
                               mlp_train_fused, render_fused)
from nnc_tpu_torch.ops.posenc import positional_encoding
from nnc_tpu_torch.ops.sampling import stratified_samples
from nnc_tpu_torch.parallel import multi_scene
from nnc_tpu_torch.render import mipnerf, occupancy, renderer
from nnc_tpu_torch.render.rays import get_rays_np, ndc_rays
from nnc_tpu_torch.tools import (bench_render_v2, bench_train_step,
                                 demo_synthetic, lsa_profile, profile_codec,
                                 profile_fast_frame, rd_sweep, render_video,
                                 render_work, tp_mlp_bench, tune_fast_mode)
from nnc_tpu_torch.tools import multi_scene as multi_scene_tool
from nnc_tpu_torch.train import classification, lsa, presets
from nnc_tpu_torch.utils import ckpt, profiling
from nnc_tpu_torch.utils.device import require_cuda
from nnc_tpu_torch.utils.logging import read_result_file
from nnc_tpu_torch.utils.platform import card_line

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "build", "chip_smoke")
# lego at half resolution: 400x400, camera_angle_x 0.6911112070083618
LEGO_HW = 400
LEGO_FOCAL = 0.5 * LEGO_HW / math.tan(0.5 * 0.6911112070083618)
FERN_HW = (378, 504)   # fern at factor 8
N_POINTS = 262_144     # K-B3 comparison
RAGGED = (33, 10_000, 3_414_016)   # K-B3 at sizes that are no tile multiple
N_RAYS = 4096          # K-B2 comparison
N_TRAIN = (65_536, 196_608)   # K-B1: one LSA step's coarse and fine points
# K-B1's IPE instantiation: a tenth of a mip-NeRF step, and its two levels
# of 4,096 rays x 128 samples
N_IPE = (104_832, 1_048_576)
# multiply-adds a point of mip-NeRF's MLP forward, and of the backward
# without dW (the encodings' rows get no gradient); vanilla's forward
IPE_FWD_MACS, IPE_BWD_MACS, KB1_FWD_MACS = 610_304, 557_696, 593_408
IPE_LSA_RAYS, IPE_LSA_SAMPLES = 4096, 128   # phase 25's LSA steps
# K-B7: a mip-NeRF 360 step's NeRF trunk layer (16,384 rays x 32 samples x
# 1,024) and proposal layer (16,384 x 64 x 256, one of two levels)
N_KB7 = ((524_288, 1_024), (1_048_576, 256))
KB7_LSA_RAYS = 1024    # phase 26's LSA steps
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
    "mlp_int8_from_points": (
        "nnc_tpu_torch/ops/csrc/mlp_int8_from_points.cu",
        "nnc_tpu/ops/mlp_pallas.py:323"),
    "mlp_embedded": ("nnc_tpu_torch/ops/csrc/mlp_embedded.cu",
                     "nnc_tpu/ops/mlp_pallas.py:248"),
    "mlp_train_fwd": ("nnc_tpu_torch/ops/csrc/mlp_train.cu",
                      "nnc_tpu/ops/mlp_train_pallas.py:275"),
    "mlp_train_bwd": ("nnc_tpu_torch/ops/csrc/mlp_train.cu",
                      "nnc_tpu/ops/mlp_train_pallas.py:300"),
    "mlp_train_bwd_dw": ("nnc_tpu_torch/ops/csrc/mlp_train_dw.cu",
                         "nnc_tpu/ops/mlp_train_pallas.py:300"),
    "mlp_tp_pair": ("nnc_tpu_torch/ops/csrc/mlp_tp_pair.cu",
                    "nnc_tpu/ops/mlp_tp_pallas.py:82"),
    "mlp_from_points_bf16": (
        "nnc_tpu_torch/ops/csrc/mlp_from_points_bf16.cu",
        "nnc_tpu/ops/mlp_pallas.py:280"),
    "render_pass_bf16": ("nnc_tpu_torch/ops/csrc/render_pass_bf16.cu",
                         "nnc_tpu/ops/render_pallas.py:169"),
    "mlp_train_fwd_bf16": ("nnc_tpu_torch/ops/csrc/mlp_train_bf16.cu",
                           "nnc_tpu/ops/mlp_train_pallas.py:275"),
    "mlp_train_bwd_bf16": ("nnc_tpu_torch/ops/csrc/mlp_train_bf16.cu",
                           "nnc_tpu/ops/mlp_train_pallas.py:300"),
    "mlp_train_bwd_dw_bf16": ("nnc_tpu_torch/ops/csrc/mlp_train_dw.cu",
                              "nnc_tpu/ops/mlp_train_pallas.py:300"),
    "mlp_embedded_bf16": ("nnc_tpu_torch/ops/csrc/mlp_embedded_bf16.cu",
                          "nnc_tpu/ops/mlp_pallas.py:248"),
    "mlp_tp_pair_bf16": ("nnc_tpu_torch/ops/csrc/mlp_tp_pair_bf16.cu",
                         "nnc_tpu/ops/mlp_tp_pallas.py:82"),
}
# K-B6: (K, O2, relu_mid) of the forward's pairs: w0 -> w1; w2 -> w3,
# w4 -> w5b, w6 -> w7; wf -> wva. S = 256 / M.
PAIR_HEADS = ((63, 256, True), (256, 256, True), (256, 128, False))
TP_SHARDS = 4
RENDER_KERNELS = ("render_pass", "mlp_from_points")
LSA_KERNELS = ("mlp_train_fwd", "mlp_train_bwd")
LSA_BF16_KERNELS = ("mlp_train_fwd_bf16", "mlp_train_bwd_bf16")
# Published peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W):
# device memory bytes/s, float32 FLOP/s outside the tensor cores, int8 OP/s
# and TF32 FLOP/s of the tensor cores. A float32 product computed as three
# TF32 products (K-B1, K-B2, K-B3, K-B5, K-B6) is bounded by a third of the
# TF32 peak.
PEAK_BYTES, PEAK_FP32, PEAK_INT8, PEAK_TF32 = 3.35e12, 67e12, 1979e12, 495e12
PEAK_3XTF32 = PEAK_TF32 / 3
PEAK_BF16 = 989e12   # dense bf16, the bound of every bf16 kernel
# K-B3's and K-B5's raw logits against the exact float32 plain version, 10x
# the 2.4e-6 measured (K-B3) at values up to 2.7. One TF32 product instead of
# three reads 1.6e-3 in the plain model of the arithmetic, a lost correction
# term half of that, and the three products summed straight into the layer's
# accumulator (the tensor core cuts where float32 rounds) read 1.4e-5.
TOL_RAW = 3e-5
# The kernels that later designs replaced, at chip_smoke's shapes (PERF.md's
# kernel table, chip_smoke on an NVIDIA H100 80GB HBM3 at 700 W): K-B1's
# SIMT backward with dW at 196,608 points, float32 and bf16; K-B2 bf16 on
# tiles of four rays, phase 14's 4,096 rays at S = 192 with early
# termination at 1e-4, and the points those tiles computed; K-B1 bf16's
# forward storing u from the fragments at 196,608 points; K-B4 on __dp4a at
# 262,144 points; K-B3 and K-B5 on the SIMT chain of float32 FMAs at 262,144
# points; K-B1 bf16's backward without dW loading u after its products at
# 196,608 points; K-B6 on the SIMT cores at 262,144 points, M = 4, K 256,
# O2 256; K-B5 bf16 loading each tile's embedding between two tiles'
# products at 262,144 points; K-B3 bf16 on the mma.sync chain at 262,144
# points
REPLACED_MS = {"mlp_train_bwd_dw": 32.737, "mlp_train_bwd_dw_bf16": 34.796,
               "render_pass_bf16": 2.056, "mlp_train_fwd_bf16": 2.574,
               "mlp_int8_from_points": 4.976, "mlp_from_points": 14.019,
               "mlp_embedded": 14.105, "mlp_train_bwd_bf16": 1.448,
               "mlp_tp_pair": 1.292, "mlp_embedded_bf16": 1.007,
               "mlp_from_points_bf16": 0.907}
REPLACED_POINTS_BF16 = 568_448
_DIMS = nerf._layer_dims(nerf.NeRFConfig()).values()
# multiply-adds of the MLP per point: all weights and biases (595,844); the
# int8 products (no biases); and the backward's dx products, which skip the
# blocks that act on the embeddings (w0, w5a, wvb)
MLP_MACS = sum(din * dout + dout for din, dout in _DIMS)
INT8_MACS = sum(rows * out for *_, rows, out in mlp_fused.INT8_BLOCKS)
BWD_MACS = INT8_MACS - 2 * 63 * 256 - 27 * 128


SASS_DUMP = None   # cuobjdump's run on the built library (phases 1 to 14)
SASS_PATH = os.path.join(OUT, "libnnc_kernels.sass")


def library_opcodes(function):
    """The SASS opcode counts of the built library's kernels whose mangled
    name contains ``function`` (the dump started in phase 1, waited for
    once)."""
    if SASS_DUMP.returncode is None:
        dump_err = SASS_DUMP.communicate(timeout=300)[1]
        check(SASS_DUMP.returncode == 0, f"cuobjdump failed: {dump_err}")
    with open(SASS_PATH) as f:
        return _build.opcodes(_build.LIB_PATH, function, f.read())


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


def bound(n_bytes, ops, peak_ops):
    """The least milliseconds the card could take: bytes moved once over its
    memory rate against operations over the peak rate for their type.
    library_ms is None throughout: no single PyTorch call computes any of
    these functions (each is a chain of twelve dependent products)."""
    by_bytes, by_ops = 1e3 * n_bytes / PEAK_BYTES, 1e3 * ops / peak_ops
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes > by_ops else "operations",
            "library_ms": None}


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def phase_environment():
    dev = require_cuda()
    card = card_line().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()} nvcc {_build._nvcc()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the codec's CABAC library (g++) is built beside the kernels, on a core
    # that nvcc's longest sources leave idle
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        t0 = time.perf_counter()
        codec = pool.submit(lambda: (cabac._load(), time.perf_counter() - t0))
        seconds = _build.build(force=True)
        t_cabac = codec.result()[1]
    _build.lib()
    # the library's SASS, for phase 9, dumped while the phases before it run
    global SASS_DUMP
    with open(SASS_PATH, "w") as f:
        SASS_DUMP = subprocess.Popen([_build.cuobjdump(), "-sass",
                                      _build.LIB_PATH], stdout=f,
                                     stderr=subprocess.PIPE, text=True)
    print(f"[1] kernels built in {seconds:.1f} s -> {_build.LIB_PATH}; the "
          f"CABAC library beside them in {t_cabac:.1f} s")
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
    packed_mma = mlp_fused.repack_mma(packed)
    check(_build.lib().nnc_mma_params_size() == mlp_fused.MMA_PARAMS_SIZE,
          "the kernel's and the packing's buffer sizes differ")
    run = lambda p=pts, v=vd: mlp_fused.mlp_from_points(packed, p, v,
                                                        packed_mma)
    got = run()
    torch.cuda.synchronize()
    want = mlp_fused.fused_nerf_mlp_from_points_plain(packed, pts, vd)
    err = maxabs(got, want)
    act = lambda r: torch.cat([torch.sigmoid(r[:, :3]),
                               torch.relu(r[:, 3:])], -1)
    err_act = maxabs(act(got), act(want))
    check(torch.isfinite(got).all().item(), "K-B3 output not finite")
    check(err <= TOL_RAW, f"K-B3 max |draw| {err} > {TOL_RAW}")
    check(err_act <= TOL_RAW, f"K-B3 max |d activated| {err_act} > {TOL_RAW}")
    check(torch.equal(run(), got), "K-B3 reruns differ")
    check(torch.equal(mlp_fused.mlp_from_points(packed, pts, vd), got),
          "K-B3 on a buffer repacked by the wrapper differs")
    ragged = {}
    for m in RAGGED:
        p = (4 * torch.rand(m, 3, generator=g) - 2).to(dev)
        v = vd[torch.randint(n, (m,), generator=g).to(dev)].contiguous()
        ragged[m] = maxabs(run(p, v),
                           mlp_fused.fused_nerf_mlp_from_points_plain(
                               packed, p, v))
        check(ragged[m] <= TOL_RAW, f"K-B3 {m} points: max |draw| "
              f"{ragged[m]} > {TOL_RAW}")
    # the plain model of the kernel's arithmetic on the same inputs
    pe = positional_encoding(pts, 10).contiguous()
    ve = positional_encoding(vd, 4).contiguous()
    L = mlp_fused.unpack_weights(packed)
    err_model = maxabs(got, mlp_fused.mlp_3xtf32_plain(L, pe, ve))
    # in turns: the kernel and the plain version (cuBLAS)
    plain = lambda: mlp_fused.fused_nerf_mlp_from_points_plain(packed, pts,
                                                               vd)
    times = [[cuda_ms(fn) for fn in (run, plain)] for _ in range(2)]
    ms, plain_ms = (min(t) for t in zip(*times))
    flop = 2 * MLP_MACS * n
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound(nbytes(packed_mma, pts, vd, got), flop, PEAK_3XTF32),
           "peak_tflops": PEAK_3XTF32 / 1e12}
    print(f"[2] K-B3 {n} points: max|draw| {err:.3e} (activated "
          f"{err_act:.3e}; {err_model:.3e} against the plain 3xTF32 model; "
          f"ragged { {m: f'{e:.3e}' for m, e in ragged.items()} }), reruns "
          f"bit-equal")
    print(f"    in turns, ms: K-B3 {[f'{t[0]:.3f}' for t in times]}, plain "
          f"{[f'{t[1]:.3f}' for t in times]}; K-B3 {flop / ms / 1e9:.2f} "
          f"TFLOP/s (the SIMT kernel it replaced "
          f"{REPLACED_MS['mlp_from_points']:.3f} ms, PERF.md), bound "
          f"{row['bound_ms']:.3f} ms by {row['bound_by']} at "
          f"{row['peak_tflops']:.0f} TFLOP/s: {100 * row['bound_ms'] / ms:.1f}"
          f"% reached")
    return row, {"model": model, "packed": packed, "packed_mma": packed_mma,
                 "pts": pts, "vd": vd, "raw": got, "raw_plain": want}


def render_cases(dev):
    """The inputs of phases 3 and 14, the same from one seed: a solid
    full-width model, N_RAYS of a lego-geometry view's rays in random order,
    a quarter of them in dead culling groups, and for S = 64 (with weights)
    and S = 192 (without) sorted samples. Yields (model, (ro, rd, vd, z,
    dists, live), S, want_weights)."""
    g = torch.Generator().manual_seed(1)
    model = synthetic.make_solid_mlp(noise_std=1e-2, generator=g, device=dev)
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
    for S, want_w in ((64, True), (192, False)):
        z, _ = torch.sort(2 + 4 * torch.rand(R, S, generator=g), dim=-1)
        z = z.to(dev)
        dists = torch.cat([z[:, 1:] - z[:, :-1],
                           torch.full_like(z[:, :1], 1e10)], -1) \
            * torch.linalg.norm(rd, dim=-1, keepdim=True)
        yield model, (ro, rd, vd, z, dists, live), S, want_w


def optical_depth_before(raw, dists):
    """The optical depth before each sample, from raw (R * S, 4)."""
    tau = torch.cumsum(torch.relu(raw[:, 3]).reshape(dists.shape) * dists,
                       dim=-1)
    return torch.cat([torch.zeros_like(tau[:, :1]), tau[:, :-1]], -1)


def points_of(before, live, term, ray_tile):
    """(points these rays need, points the kernel's tiles compute for them):
    a sample of a live ray counts while the ray's transmittance before it is
    still >= eps; a tile computes every block of SAMPLE_BLOCK samples of a
    live tile of ``ray_tile`` rays at whose start one of its rays is still
    below the threshold."""
    R, sb = before.shape[0], render_fused.SAMPLE_BLOCK
    needed = int(((before < term) & (live[:, None] > 0)).sum())
    starts = before[:, ::sb].reshape(R // ray_tile, ray_tile, -1).amin(dim=1)
    tile_live = live.reshape(R // ray_tile, ray_tile).amax(dim=1) > 0
    computed = int(((starts < term) & tile_live[:, None]).sum()) \
        * ray_tile * sb
    return needed, computed


def phase_render(dev):
    R = N_RAYS
    worst, row = 0.0, None
    for model, rays, S, want_w in render_cases(dev):
        ro, rd, vd, z, dists, live = rays
        packed = mlp_fused.pack_weights(model)
        packed_mma = mlp_fused.repack_mma(packed)
        # the optical depth before each sample, for the work the rays need
        pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
        raw = mlp_fused.mlp_from_points(
            packed, pts.reshape(-1, 3).contiguous(),
            vd[:, None, :].expand(R, S, 3).reshape(-1, 3).contiguous(),
            packed_mma)
        before = optical_depth_before(raw, dists)
        for eps in (0.0, 1e-4):
            term = -math.log(eps) if eps > 0 else math.inf
            args = (packed, ro, rd, vd, z, dists, live, term, want_w)
            run = lambda: render_fused.render_pass(*args,
                                                   packed_mma=packed_mma)
            maps, w = run()
            torch.cuda.synchronize()
            maps_p, w_p = render_fused.fused_render_pass_plain(*args)
            d_rgb_acc = maxabs(maps[:, :4], maps_p[:, :4])
            d_depth = maxabs(maps[:, 4], maps_p[:, 4])
            d_w = maxabs(w, w_p) if want_w else 0.0
            # 10x what was measured with early termination off: rgb/acc
            # 8.3e-7, depth 7.9e-6 (it sums w * z, z <= 6); the weights
            # (1.7e-5, at sigma * dist up to ~100) at the 1e-4 they had
            tol, tol_w, tol_depth = (1e-5, 1e-4, 1e-4) if eps == 0 else \
                (2 * eps, 2 * eps, 2 * eps * 6.0)
            check(torch.isfinite(maps).all().item(), "K-B2 maps not finite")
            check(d_rgb_acc <= tol and d_w <= tol_w and d_depth <= tol_depth,
                  f"K-B2 S={S} eps={eps}: rgb/acc {d_rgb_acc}, depth "
                  f"{d_depth}, weights {d_w}")
            check(float(maps[live == 0].abs().max()) == 0.0,
                  "K-B2 dead tiles not zero")
            maps_2, w_2 = run()
            check(torch.equal(maps_2, maps)
                  and (not want_w or torch.equal(w_2, w)),
                  "K-B2 reruns differ")
            if eps == 0:
                worst = max(worst, d_rgb_acc, d_w)
            ms = cuda_ms(run)
            plain_ms = cuda_ms(
                lambda: render_fused.fused_render_pass_plain(*args))
            needed, computed = points_of(before, live, term,
                                         render_fused.RAY_TILE)
            b = bound(nbytes(packed_mma, ro, rd, vd, z, dists, live, maps),
                      2 * MLP_MACS * needed, PEAK_3XTF32)
            print(f"[3] K-B2 {R} rays S={S} weights={want_w} eps={eps}: "
                  f"max|d| rgb/acc {d_rgb_acc:.3e} depth {d_depth:.3e} "
                  f"weights {d_w:.3e}, reruns bit-equal; kernel {ms:.3f} ms, "
                  f"plain {plain_ms:.3f} ms; {needed} of {R * S} points "
                  f"needed ({computed} computed in tiles, "
                  f"{2 * MLP_MACS * computed / ms / 1e9:.2f} TFLOP/s): "
                  f"{2 * MLP_MACS * needed / ms / 1e9:.2f} TFLOP/s, "
                  f"bound {b['bound_ms']:.3f} ms by {b['bound_by']} at "
                  f"{PEAK_3XTF32 / 1e12:.0f} TFLOP/s: "
                  f"{100 * b['bound_ms'] / ms:.1f}% reached")
            if S == 192 and eps > 0:
                row = {"ms": ms, "plain_ms": plain_ms, **b,
                       "peak_tflops": PEAK_3XTF32 / 1e12}
    return {"max_abs_err": worst, **row}


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

    # the same compression with IOQ's probe on the plain path: sample_pdf is
    # discontinuous in the coarse weights, so the two QP searches may settle
    # on other bytes (reported, not asserted)
    bs_p = os.path.join(OUT, "teacher_plain_probe.nnc")
    before_p = _build.launch_counts()
    t0 = time.perf_counter()
    nnc_tpu_torch.compress_model(tar, bitstream_path=bs_p, qp=-20, lsa=False,
                                 ioq=True, scene=scene, use_fused_mlp=False,
                                 device=dev, verbose=False)
    torch.cuda.synchronize()
    t_compress_p = time.perf_counter() - t0
    check(_build.launch_counts() == before_p,
          "the plain probe launched a kernel")

    size = os.path.getsize(bs)
    raw = sum(np.asarray(v).nbytes for v in sd.values())
    print(f"[4] lego-geometry slice {LEGO_HW}x{LEGO_HW}: {size} B of {raw} B "
          f"({100.0 * size / raw:.2f}%; {os.path.getsize(bs_p)} B with the "
          f"probe on the plain path); decoded test PSNR kernels "
          f"{psnr_k:.4f} dB, plain {psnr_p:.4f} dB, diff "
          f"{psnr_k - psnr_p:+.4f} dB; teacher through kernels "
          f"{teacher_k:.2f} dB")
    print(f"    launches during IOQ {ioq_launches}, after test_model "
          f"{after_k}")
    print(f"    times: ground truth {t_gt:.1f} s, compress (IOQ) "
          f"{t_compress:.1f} s (plain probe {t_compress_p:.1f} s), decode "
          f"{t_decode:.2f} s, test_model (one {LEGO_HW}x{LEGO_HW} view) "
          f"kernels {t_test_k:.2f} s, plain {t_test_p:.2f} s")
    check(all(np.isfinite([psnr_k, psnr_p, teacher_k])), "PSNR not finite")
    check(abs(psnr_k - psnr_p) <= 0.05,
          f"kernel vs plain test PSNR differ by {psnr_k - psnr_p} dB")
    check(teacher_k > 40.0, f"teacher re-render through kernels only "
          f"{teacher_k} dB against its plain ground truth")
    check(psnr_k > 20.0, f"decoded model test PSNR {psnr_k} dB")
    check(ioq_launches["render_pass"] > 0, "IOQ probe ran no K-B2")
    return scene, sd, tar, dec, psnr_k


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
    ex_p = presets.create_nerf_model_executer(scene=scene, device=dev,
                                              use_fused_mlp=False,
                                              verbose=False)
    t0 = time.perf_counter()
    psnr_p = ex_p.test_model(sd)
    torch.cuda.synchronize()
    t_test_p = time.perf_counter() - t0
    check(_build.launch_counts()["mlp_from_points"] - before == launched,
          "the plain NDC render launched K-B3")
    print(f"[5] LLFF-style NDC {FERN_HW[0]}x{FERN_HW[1]}, 64+64: teacher "
          f"test PSNR through K-B3 {psnr:.2f} dB in {t_test:.2f} s, "
          f"{launched} K-B3 launches; plain path {psnr_p:.2f} dB in "
          f"{t_test_p:.2f} s")
    check(np.isfinite(psnr) and psnr > 40.0,
          f"NDC render through K-B3 {psnr} dB against its plain ground truth")
    check(launched > 0, "the LLFF-style path ran no K-B3")
    return scene, sd, psnr


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
    # what the tensor-core kernels read: the cached wgmma weight images
    # and the bias vector, as fused_nerf_mlp_train hands them over
    packed_wg, packed_wg_t = mlp_train_fused.pack_train_wgmma(tensors[0::3])
    biases = mlp_train_fused.gather_biases(params)
    row = {}
    for n in N_TRAIN:
        pts = (4 * torch.rand(n, 3, generator=g) - 2).to(dev)
        vd = torch.randn(n, 3, generator=g)
        vd = (vd / torch.linalg.norm(vd, dim=-1, keepdim=True)).to(dev)
        cot = (1e-3 * torch.randn(n, 4, generator=g)).to(dev)

        def fwd():
            return mlp_train_fused.mlp_train_fwd(
                params, ls, pts, vd, save_u=True, packed_wg=packed_wg,
                biases=biases)

        def bwd(with_dw):
            return mlp_train_fused.mlp_train_bwd(
                params, params_t, ls, pts, vd, cot, ws, with_dw,
                packed_wg_t=packed_wg_t, biases=biases)

        raw, ws = fwd()
        torch.cuda.synchronize()
        raw_p = mlp_train_fused.mlp_train_fwd_plain(params, ls, pts, vd)
        err_raw = maxabs(raw, raw_p)
        check(torch.isfinite(raw).all().item(), "K-B1 forward not finite")
        check(err_raw <= 1e-3, f"K-B1 forward max |draw| {err_raw} > 1e-3")
        # the buffers made inside the wrappers from pack_train's are the same
        raw_m, ws_m = mlp_train_fused.mlp_train_fwd(params, ls, pts, vd,
                                                    save_u=True)
        check(torch.equal(raw_m, raw) and torch.equal(ws_m, ws),
              "K-B1 forward differs between given and made buffers")
        del raw_m, ws_m
        fwd_ms = cuda_ms(fwd)
        pe, ve = positional_encoding(pts, 10), positional_encoding(vd, 4)
        for with_dw in (False, True):
            flat = bwd(with_dw)
            torch.cuda.synchronize()
            flat_p = mlp_train_fused.mlp_train_bwd_plain(
                params, params_t, ls, pts, vd, cot, with_dw)
            err_g, err_g_abs, ok = grad_errors(
                mlp_train_fused.split_grads(flat, with_dw),
                mlp_train_fused.split_grads(flat_p, with_dw))
            check(torch.isfinite(flat).all().item(), "K-B1 grads not finite")
            check(ok, f"K-B1 backward n={n} with_dw={with_dw}: gradients "
                  f"off the plain version's (worst {err_g:.3e} of scale)")
            check(torch.equal(bwd(with_dw), flat),
                  "K-B1 backward not deterministic")
            bwd_ms = cuda_ms(lambda: bwd(with_dw))

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
            # every product on the tensor cores as three TF32 products: the
            # forward, the backward's dx products and with dW the x^T du
            # products of the GEMM too (every weight once more)
            bwd_name = "mlp_train_bwd_dw" if with_dw else "mlp_train_bwd"
            rows = {"mlp_train_fwd": {
                        "max_abs_err": err_raw, "ms": fwd_ms,
                        "plain_ms": plain_fwd_ms,
                        **bound(nbytes(packed_wg, ls, biases, pts, vd, raw,
                                       ws), 2 * MLP_MACS * n, PEAK_3XTF32)},
                    bwd_name: {
                        "max_abs_err": err_g_abs, "ms": bwd_ms,
                        "plain_ms": plain_bwd_ms,
                        **bound(nbytes(packed_wg_t, ls, biases, cot, ws,
                                       flat) + (nbytes(pts, vd) if with_dw
                                                else 0),
                                2 * (BWD_MACS + (INT8_MACS if with_dw
                                                 else 0)) * n, PEAK_3XTF32)}}
            replaced = f" (the SIMT kernel it replaced: " \
                f"{REPLACED_MS[bwd_name]:.3f} ms, PERF.md)" \
                if with_dw and n == N_TRAIN[-1] else ""
            print(f"[6] K-B1 {n} points with_dw={with_dw}: max|draw| "
                  f"{err_raw:.3e}, worst gradient error {err_g:.3e} of its "
                  f"max ({err_g_abs:.3e} absolute); kernel fwd "
                  f"{fwd_ms:.3f} ms + bwd {bwd_ms:.3f} ms{replaced}, "
                  f"plain fwd {plain_fwd_ms:.3f} ms + autograd bwd "
                  f"{plain_bwd_ms:.3f} ms; bounds fwd "
                  f"{rows['mlp_train_fwd']['bound_ms']:.3f} ms, bwd "
                  f"{rows[bwd_name]['bound_ms']:.3f} ms (3xTF32 peak)")
            if n == N_TRAIN[-1]:
                row.update(rows)
        del ws
    return row


def _lsa_run(ex, model_c, model_f, draws, mesh=None, grid=None):
    """TRAJ_STEPS LSA steps from the given models on the executer's batches
    and the given draws, data-parallel over ``mesh`` if given, on the
    occupancy loss over ``grid`` if given; returns (scales {name: (out,)}
    of both models, mean step ms on the host clock)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ls_c, ls_f, *_ = lsa.tune_lsa_scales(
        model_c, model_f, ex._make_batcher(), ex.rc, ex.scene["near"],
        ex.scene["far"], learning_rate=ex.learning_rate,
        learning_rate_decay=0.0, epochs=1, n_iters=TRAJ_STEPS,
        verbose=False, draws=draws, mesh=mesh, grid=grid)
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
    return launches, dec0, sets, ls_p, psnr_lsa


def phase_embedded(dev, ctx):
    packed, packed_mma, pts, vd = (ctx[k] for k in ("packed", "packed_mma",
                                                    "pts", "vd"))
    n = pts.shape[0]
    embed = lambda p, v: (positional_encoding(p, 10).contiguous(),
                          positional_encoding(v, 4).contiguous())
    pe, ve = embed(pts, vd)
    run = lambda e=pe, f=ve: mlp_fused.mlp_embedded(packed, e, f, packed_mma)
    got = run()
    torch.cuda.synchronize()
    L = mlp_fused.unpack_weights(packed)
    model = lambda e, f: mlp_fused._chunked(
        lambda a, b: mlp_fused.mlp_3xtf32_plain(L, a, b), e, f)
    want = mlp_fused.fused_nerf_mlp_plain(packed, pe, ve)
    err, err_kb3 = maxabs(got, want), maxabs(got, ctx["raw"])
    err_model = maxabs(got, model(pe, ve))
    check(torch.isfinite(got).all().item(), "K-B5 output not finite")
    check(err <= TOL_RAW, f"K-B5 max |draw| {err} > {TOL_RAW}")
    check(err_model <= TOL_RAW, f"K-B5 against the plain 3xTF32 model: max "
          f"|draw| {err_model} > {TOL_RAW}")
    check(err_kb3 <= TOL_RAW, f"K-B5 against K-B3 max |draw| {err_kb3} > "
          f"{TOL_RAW}")
    check(torch.equal(run(), got), "K-B5 reruns differ")
    check(torch.equal(mlp_fused.mlp_embedded(packed, pe, ve), got),
          "K-B5 on a buffer repacked by the wrapper differs")
    g = torch.Generator().manual_seed(8)
    ragged = {}
    for m in RAGGED:
        p = (4 * torch.rand(m, 3, generator=g) - 2).to(dev)
        v = vd[torch.randint(n, (m,), generator=g).to(dev)].contiguous()
        e, f = embed(p, v)
        out = run(e, f)
        ragged[m] = (maxabs(out, mlp_fused.fused_nerf_mlp_plain(packed, e, f)),
                     maxabs(out, model(e, f)))
        check(max(ragged[m]) <= TOL_RAW, f"K-B5 {m} points: max |draw| "
              f"{ragged[m]} (plain, 3xTF32 model) > {TOL_RAW}")
        check(torch.equal(run(e, f), out), f"K-B5 {m} points: reruns differ")
        del e, f, out
    # its products on the tensor cores: HMMA in its SASS
    ops = library_opcodes("mlp_embedded_kernelINS_3mma5Chain")
    check(ops["HMMA"] > 0 and ops["FFMA"] < ops["HMMA"],
          f"K-B5's SASS: {ops['HMMA']} HMMA, {ops['FFMA']} FFMA")
    times = [[cuda_ms(fn) for fn in (
        run, lambda: mlp_fused.fused_nerf_mlp_plain(packed, pe, ve),
        lambda: mlp_fused.mlp_from_points(packed, pts, vd, packed_mma))]
        for _ in range(2)]
    ms, plain_ms, kb3_ms = (min(t) for t in zip(*times))
    flop = 2 * MLP_MACS * n
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound(nbytes(packed_mma, pe, ve, got), flop, PEAK_3XTF32),
           "peak_tflops": PEAK_3XTF32 / 1e12}
    print(f"[8] K-B5 {n} points: max|draw| {err:.3e} against plain, "
          f"{err_model:.3e} against the plain 3xTF32 model, {err_kb3:.3e} "
          f"against K-B3; ragged (plain, model) "
          f"{ {m: f'{a:.3e}, {b:.3e}' for m, (a, b) in ragged.items()} }; "
          f"reruns bit-equal; SASS {ops['HMMA']} HMMA, {ops['FFMA']} FFMA")
    print(f"    in turns, ms: K-B5 {[f'{t[0]:.3f}' for t in times]}, plain "
          f"{[f'{t[1]:.3f}' for t in times]}, K-B3 "
          f"{[f'{t[2]:.3f}' for t in times]}; K-B5 {flop / ms / 1e9:.2f} "
          f"TFLOP/s (the SIMT kernel it replaced "
          f"{REPLACED_MS['mlp_embedded']:.3f} ms, PERF.md), bound "
          f"{row['bound_ms']:.3f} ms by {row['bound_by']} at "
          f"{row['peak_tflops']:.0f} TFLOP/s: {100 * row['bound_ms'] / ms:.1f}"
          f"% reached")
    return row


def phase_int8(dev, ctx):
    pts, vd, ref = ctx["pts"], ctx["vd"], ctx["raw_plain"]
    n = pts.shape[0]
    wq, scales, biases = mlp_fused.pack_weights_int8(ctx["model"])
    packed_s8 = mlp_fused.pack_weights_int8_mma(ctx["model"])
    check(_build.lib().nnc_int8_mma_size() == mlp_fused.INT8_MMA_SIZE,
          "K-B4's and the int8 packing's buffer sizes differ")
    args = (wq, scales, biases, pts, vd)
    run = lambda: mlp_fused.mlp_int8_from_points(*args, packed_s8=packed_s8)
    got = run()
    torch.cuda.synchronize()
    want = mlp_fused.fused_nerf_mlp_int8_from_points_plain(*args)
    # The integer sums are exact and the float32 steps are single rounded
    # operations in one order on both sides, so the two differ only where
    # sincosf and torch's sin / cos differ in the last bit of an embedding
    # value that sits on a quantization tie: at most 1e-3 of the elements
    # may differ by more than 1e-5 (float rounding), and none by more than
    # the reference's bound against the float MLP
    # (tests/test_mlp_pallas.py:255), which the kernel itself must meet too.
    d = (got - want).abs()
    share = float((d > 1e-5).float().mean())
    limit = 0.05 * float(ref.abs().max()) + 0.05
    err, err_f32 = float(d.max()), maxabs(got, ref)
    check(torch.isfinite(got).all().item(), "K-B4 output not finite")
    check(share <= 1e-3, f"K-B4: {share} of the elements off the plain "
          f"version by more than 1e-5")
    check(err < limit, f"K-B4 max |draw| {err} against plain, bound {limit}")
    check(0 < err_f32 < limit, f"K-B4 max |draw| {err_f32} against the float "
          f"MLP, bound {limit}")
    check(torch.equal(run(), got), "K-B4 reruns differ")
    # its products on the tensor cores: IMMA in its SASS, no IDP.4A
    ops = library_opcodes("mlp_int8_from_points_kernel")
    check(ops["IMMA"] > 0 and ops["IDP"] == 0,
          f"K-B4's SASS: {ops['IMMA']} IMMA, {ops['IDP']} IDP.4A")
    ms = cuda_ms(run)
    plain_ms = cuda_ms(
        lambda: mlp_fused.fused_nerf_mlp_int8_from_points_plain(*args))
    kb3_ms = cuda_ms(lambda: mlp_fused.mlp_from_points(
        ctx["packed"], pts, vd, ctx["packed_mma"]))
    row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           **bound(nbytes(packed_s8, pts, vd, got), 2 * INT8_MACS * n,
                   PEAK_INT8)}
    print(f"[9] K-B4 {n} points, {mlp_fused.INT8_ACT_BLOCK} per activation "
          f"scale: max|draw| {err:.3e} against plain ({share:.2e} of the "
          f"elements beyond 1e-5), {err_f32:.3e} against the float MLP "
          f"(bound {limit:.3f}), reruns bit-equal; SASS {ops['IMMA']} IMMA, "
          f"0 IDP.4A; kernel {ms:.3f} ms "
          f"({2 * INT8_MACS * n / ms / 1e9:.2f} TOP/s; the __dp4a kernel it "
          f"replaced {REPLACED_MS['mlp_int8_from_points']:.3f} ms, PERF.md), "
          f"plain {plain_ms:.3f} ms, K-B3 {kb3_ms:.3f} ms, bound "
          f"{row['bound_ms']:.3f} ms by {row['bound_by']}: "
          f"{100 * row['bound_ms'] / ms:.1f}% reached")
    return row


@contextlib.contextmanager
def swapped(module, name, fn):
    """module.name is fn inside the block and what it was after it."""
    real = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield real
    finally:
        setattr(module, name, real)


def held_against_plain(name, plain, seen, module=mlp_fused):
    """Inside the block every call of the kernel wrapper <module>.<name> is
    followed by its plain version on the same tensors. ``seen`` gets, per
    launch, (points, max |d raw|, share of the elements beyond 1e-5,
    max |raw|). These launches are made after a path's counts were read."""
    real = getattr(module, name)

    def both(*args, **kernel_only):
        got = real(*args, **kernel_only)
        d = (got - plain(*args)).abs()
        seen.append((got.shape[0], float(d.max()),
                     float((d > 1e-5).float().mean()),
                     float(got.abs().max())))
        return got
    return swapped(module, name, both)


def _query_embedded(model, pts, viewdirs, rc, allow_fused=True):
    """The renderer's MLP query with the embeddings made outside the kernel,
    as its route for other posenc widths makes them (one view embedding per
    ray, broadcast over its samples), and the MLP called as fused_nerf_mlp."""
    ve = positional_encoding(viewdirs, rc.multires_views)
    return mlp_fused.fused_nerf_mlp(
        model, positional_encoding(pts, rc.multires),
        ve[..., None, :].expand(*pts.shape[:-1], ve.shape[-1]))


def phase_lowprec_slice(dev, scene, sd, psnr_kb3):
    make = lambda: presets.create_nerf_model_executer(
        scene=scene, device=dev, use_fused_mlp=True, verbose=False)
    ex = make()
    ex8 = make()
    ex8.rc = dataclasses.replace(ex8.rc, use_int8_mlp=True)
    # a second pair of full-width models, random with visible density and
    # LSA scales (phase 2's kind): the solid teacher carries its density
    # through one channel of an identity chain times 100, which no trained
    # network does and which int8 activations resolve to ~1 unit of sigma
    g = torch.Generator().manual_seed(6)
    fog = [nerf.init_lsa_scales(
        synthetic._activate(nerf.init_params(nerf.NeRFConfig(), g), g),
        std=0.05, generator=g) for _ in range(2)]
    sd_fog = nerf.params_to_state_dict(fog[0], "model.")
    sd_fog.update(nerf.params_to_state_dict(fog[1], "model_fine."))
    view = scene["i_test"][:1]

    _build.reset_launch_counts()
    t0 = time.perf_counter()
    psnr_int8 = ex8.test_model(sd)
    torch.cuda.synchronize()
    t_int8 = time.perf_counter() - t0
    rgb8, _ = ex8._render_views(*ex8._split_params(sd_fog), view)
    counts = _build.launch_counts()
    launches = {"mlp_int8_from_points": counts["mlp_int8_from_points"]}
    check(counts["mlp_from_points"] == 0 and counts["render_pass"] == 0,
          f"the int8 renders launched a float kernel: {counts}")
    # the same view of the same models through K-B3, image against image;
    # each K-B3 launch of it held against the plain version
    fog_c, fog_f = ex._split_params(sd_fog)
    seen = {name: [] for name in ("mlp_from_points", "mlp_int8_from_points",
                                  "mlp_embedded")}
    with held_against_plain("mlp_from_points",
                            mlp_fused.fused_nerf_mlp_from_points_plain,
                            seen["mlp_from_points"]):
        rgbf, _ = ex._render_views(fog_c, fog_f, view)
    # the K-B4 view once more with each launch held against the plain int8
    # version, then the whole view through the plain int8 version: kernel
    # and plain version are meant to agree bit for bit, so the two images
    # differ only where a tie flipped (see phase 9), far-sample steps
    # included
    with held_against_plain("mlp_int8_from_points",
                            mlp_fused.fused_nerf_mlp_int8_from_points_plain,
                            seen["mlp_int8_from_points"]):
        rgb8_again, _ = ex8._render_views(fog_c, fog_f, view)
    with swapped(mlp_fused, "mlp_int8_from_points",
                 mlp_fused.fused_nerf_mlp_int8_from_points_plain):
        rgb8_plain, _ = ex8._render_views(fog_c, fog_f, view)
    d_plain = np.abs(rgb8 - rgb8_plain)[0].max(-1).reshape(-1)
    share_plain = float((d_plain > 1e-5).mean())
    d_pix = np.abs(rgb8 - rgbf)[0].max(-1).reshape(-1)
    between = -10.0 * math.log10(float(np.mean((rgb8 - rgbf) ** 2)))
    # raw2outputs gives the last sample of a ray (at the far plane, dist
    # 1e10) alpha 1 where its sigma is above zero and alpha 0 where it is
    # not: a step in sigma that an error of any size can cross. The rays
    # whose far sample the float model puts within the int8 error of zero
    # may flip; every other pixel is held to the reference's bound.
    H, W, K = scene["H"], scene["W"], np.asarray(scene["K"], np.float32)
    ro, rd = get_rays_np(H, W, K, scene["poses"][view[0]][:3, :4])
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    ro_n, rd_n = ndc_rays(H, W, float(K[0][0]), 1.0,
                          torch.as_tensor(ro, device=dev),
                          torch.as_tensor(rd, device=dev))
    raw_far = mlp_fused.fused_nerf_mlp_from_points(
        fog_f, (ro_n + rd_n * scene["far"]).reshape(-1, 3),
        torch.as_tensor(vd.reshape(-1, 3), device=dev))
    near_zero = (raw_far[:, 3].abs()
                 <= 0.05 * raw_far.abs().max() + 0.05).cpu().numpy()
    d_rgb = float(d_pix[~near_zero].max())
    n_flipped = int((d_pix > 0.1).sum())

    _build.reset_launch_counts()
    with swapped(renderer, "_query_mlp", _query_embedded):
        t0 = time.perf_counter()
        psnr_emb = ex.test_model(sd)
        torch.cuda.synchronize()
        t_emb = time.perf_counter() - t0
        counts = _build.launch_counts()
        with held_against_plain("mlp_embedded", mlp_fused.fused_nerf_mlp_plain,
                                seen["mlp_embedded"]):
            ex._render_views(*ex._split_params(sd), view)
    launches["mlp_embedded"] = counts["mlp_embedded"]
    check(counts["mlp_from_points"] == 0,
          f"the embedded render launched K-B3: {counts}")
    # the shapes the renderer gives the wrappers: chunks of rc.chunk rays and
    # the ragged last one, coarse (n_samples) and fine (+ n_importance)
    rays, rc = H * W, ex.rc
    sizes = {min(rc.chunk, rays - r0) * s
             for r0 in range(0, rays, rc.chunk)
             for s in (rc.n_samples, rc.n_samples + rc.n_importance)}
    for name, rows in seen.items():
        check({r[0] for r in rows} == sizes
              and len(rows) == 2 * -(-rays // rc.chunk),
              f"{name}: held launches of {sorted({r[0] for r in rows})} points,"
            f" {len(rows)} in all; the view has {sorted(sizes)}")
        worst = max(r[1] for r in rows)
        if name == "mlp_int8_from_points":
            # phase 9's tolerance, at each launch
            check(all(r[2] <= 1e-3 and r[1] < 0.05 * r[3] + 0.05
                      for r in rows),
                  f"K-B4 at the view's shapes off its plain version: {rows}")
        else:
            check(worst <= 1e-3, f"{name} at the view's shapes: max |draw| "
                  f"{worst} > 1e-3 against plain: {rows}")
        print(f"[10] {name}: {len(rows)} launches of one view, "
              f"{min(sizes)} to {max(sizes)} points, each against its plain "
              f"version: max|draw| {worst:.3e}, at most "
              f"{max(r[2] for r in rows):.2e} of a launch's elements beyond "
              f"1e-5")
    print(f"[10] K-B4 view against the same view through the plain int8 "
          f"version: max|d rgb| {d_plain.max():.3e}, {share_plain:.2e} of "
          f"the pixels beyond 1e-5")
    check(np.array_equal(rgb8, rgb8_again), "two K-B4 renders of one view "
          "differ")
    check(share_plain <= 1e-4, f"K-B4 render: {share_plain} of the pixels "
          f"off the plain int8 render by more than 1e-5")
    print(f"[10] low-precision slice, NDC {FERN_HW[0]}x{FERN_HW[1]}, 64+64: "
          f"teacher test PSNR through K-B4 {psnr_int8:.2f} dB in "
          f"{t_int8:.2f} s (through K-B3 {psnr_kb3:.2f} dB); random "
          f"full-width models, int8 against float render {between:.2f} dB, "
          f"max|d rgb| {d_rgb:.4f} over the {int((~near_zero).sum())} "
          f"pixels whose far sample cannot change sign, {d_pix.max():.4f} "
          f"over all {d_pix.size} ({n_flipped} beyond 0.1); teacher through "
          f"K-B5 {psnr_emb:.4f} dB "
          f"in {t_emb:.2f} s ({psnr_emb - psnr_kb3:+.4f} dB from K-B3); "
          f"launches {launches}")
    check(np.isfinite([psnr_int8, psnr_emb, between]).all()
          and np.isfinite(rgb8).all(), "PSNR or image not finite")
    # int8 logits are off by up to a few hundredths, the colours by a
    # quarter of that: the two renders of one model stay within 40 dB of
    # each other, every pixel that cannot flip within the reference's bound
    # for this route (tests/test_mlp_pallas.py:274), and at most 1e-3 of
    # all pixels beyond it. The solid teacher, whose ground truth is its
    # plain float render, is held to 25 dB: its surface pixels move by more
    # than 0.1.
    check(between > 40.0 and 0 < d_rgb < 0.1
          and (~near_zero).sum() > 0.5 * d_pix.size
          and n_flipped <= 1e-3 * d_pix.size,
          f"int8 render {between} dB from the float render, max |d rgb| "
          f"{d_rgb} away from far-sample flips, {n_flipped} pixels beyond "
          f"0.1")
    check(psnr_int8 > 25.0, f"solid teacher through K-B4 {psnr_int8} dB")
    check(abs(psnr_emb - psnr_kb3) <= 0.05,
          f"K-B5 render {psnr_emb} dB, K-B3 render {psnr_kb3} dB")
    return launches


def _pair_inputs(n, k, s, o2, g, dev):
    x = torch.randn(n, k, generator=g).to(dev)
    wa = (torch.randn(k, s, generator=g) / math.sqrt(k)).to(dev)
    ba = torch.randn(s, generator=g).to(dev)
    wb = (torch.randn(s, o2, generator=g) / math.sqrt(s)).to(dev)
    return x, wa, ba, wb


def phase_tp_pair(dev):
    """K-B6 against its plain version (torch.addmm, relu, torch.mm: cuBLAS
    in float32). Bound on the error: 1e-4 of max |ref| + 1e-5 (two float32
    products, sums over at most 256 terms in another order); against the
    plain model of its 3xTF32 arithmetic TOL_RAW. library_ms is None: the
    function is three PyTorch calls, whose summed time is plain_ms."""
    g = torch.Generator().manual_seed(7)
    n = N_POINTS
    shapes = [(TP_SHARDS, *head) for head in PAIR_HEADS] + \
        [(m, *head) for m in (1, 8) for head in PAIR_HEADS[:2]]
    # its products on the tensor cores: HMMA in its SASS, no FFMA loop
    ops = library_opcodes("18mlp_tp_pair_kernelILi")
    check(ops["HMMA"] > 0 and ops["FFMA"] == 0,
          f"K-B6's SASS: {ops['HMMA']} HMMA, {ops['FFMA']} FFMA")
    print(f"[11] K-B6's SASS (8 instances): {ops['HMMA']} HMMA, "
          f"{ops['FFMA']} FFMA")
    row = None
    for m, k, o2, relu_mid in shapes:
        s = 256 // m
        args = (*_pair_inputs(n, k, s, o2, g, dev), relu_mid)
        got = mlp_tp_fused.fused_pair(*args)
        torch.cuda.synchronize()
        want = mlp_tp_fused.fused_pair_plain(*args)
        err, limit = maxabs(got, want), 1e-4 * float(want.abs().max()) + 1e-5
        err_model = maxabs(got, mlp_tp_fused.fused_pair_3xtf32_plain(*args))
        check(torch.isfinite(got).all().item(), "K-B6 output not finite")
        check(err <= limit, f"K-B6 M={m} K={k} S={s} O2={o2}: max |d| {err} "
              f"> {limit}")
        check(err_model <= TOL_RAW, f"K-B6 M={m} K={k} S={s} O2={o2} against "
              f"the plain 3xTF32 model: max |d| {err_model} > {TOL_RAW}")
        check(torch.equal(got, mlp_tp_fused.fused_pair(*args)),
              "K-B6 reruns differ")
        times = [[cuda_ms(fn) for fn in (
            lambda: mlp_tp_fused.fused_pair(*args),
            lambda: mlp_tp_fused.fused_pair_plain(*args))] for _ in range(2)]
        ms, plain_ms = (min(t) for t in zip(*times))
        flop = 2 * n * s * (k + o2)
        b = bound(nbytes(*args[:4], got), flop, PEAK_3XTF32)
        print(f"[11] K-B6 {n} points M={m} K={k} S={s} O2={o2} "
              f"relu_mid={relu_mid}: max|d| {err:.3e} (bound {limit:.3e}, "
              f"{err / float(want.abs().max()):.2e} of max|ref|), "
              f"{err_model:.3e} against the 3xTF32 model; in turns, ms: "
              f"kernel {[f'{t[0]:.3f}' for t in times]} "
              f"({flop / ms / 1e9:.2f} TFLOP/s), cuBLAS "
              f"{[f'{t[1]:.3f}' for t in times]}; bound {b['bound_ms']:.3f} "
              f"ms by {b['bound_by']} ({100 * b['bound_ms'] / ms:.1f}% "
              f"reached)" + (f"; the SIMT kernel it replaced "
                             f"{REPLACED_MS['mlp_tp_pair']:.3f} ms (PERF.md)"
                             if (m, k, o2) == (TP_SHARDS, 256, 256) else ""))
        if (m, k, o2) == (TP_SHARDS, 256, 256):
            # the row of the kernel table: the pair that the forward runs
            # three times per shard (w2 -> w3, w4 -> w5b, w6 -> w7)
            row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b}
    return row


def first_launch_embeddings(dev, scene, rc):
    """The embeddings of the first launch of the NDC scene's first test view,
    as the renderer makes them: (R, rc.n_samples, 63) and (..., 27) for the
    launch's R rays, the view embedding broadcast over a ray's samples."""
    H, W, K = scene["H"], scene["W"], np.asarray(scene["K"], np.float32)
    ro, rd = get_rays_np(H, W, K, scene["poses"][scene["i_test"][0]][:3, :4])
    vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
    ro_n, rd_n = ndc_rays(H, W, float(K[0][0]), 1.0,
                          torch.as_tensor(ro, device=dev),
                          torch.as_tensor(rd, device=dev))
    R = min(rc.chunk, H * W)
    ro_n, rd_n = ro_n.reshape(-1, 3)[:R], rd_n.reshape(-1, 3)[:R]
    z = stratified_samples(scene["near"], scene["far"], rc.n_samples, R,
                           False, device=dev)
    pts = ro_n[:, None, :] + rd_n[:, None, :] * z[..., None]
    pe = positional_encoding(pts, rc.multires)
    ve = positional_encoding(torch.as_tensor(vd.reshape(-1, 3)[:R],
                                             device=dev), rc.multires_views)
    return pe, ve[:, None, :].expand(R, rc.n_samples, ve.shape[-1])


def phase_tp_slice(dev, scene, sd):
    """fused_nerf_mlp_tp on 4 x cuda:0 at full width on the embeddings of
    the first launch of one NDC view, as the renderer makes them."""
    H, W = scene["H"], scene["W"]
    ex = presets.create_nerf_model_executer(scene=scene, device=dev,
                                            use_fused_mlp=True, verbose=False)
    rc = ex.rc
    model, _fine = ex._split_params(sd)
    pe, ve = first_launch_embeddings(dev, scene, rc)
    n = pe.shape[0] * pe.shape[1]
    mesh = parallel.make_mesh(TP_SHARDS, ("model",))
    check(mesh.shape == {"model": TP_SHARDS}
          and all(d == dev for d in mesh.devices.flat), f"mesh {mesh}")

    _build.reset_launch_counts()
    with torch.no_grad():
        got = mlp_tp_fused.fused_nerf_mlp_tp(model, pe, ve, mesh)
        torch.cuda.synchronize()
        launched = _build.launch_counts()["mlp_tp_pair"]
        want = mlp_fused.fused_nerf_mlp(model, pe, ve)
        dense = nerf.apply_mlp(model, pe.reshape(-1, 63), ve.reshape(-1, 27))
    scale = float(want.abs().max())
    err, err_dense = maxabs(got, want), maxabs(got.reshape(-1, 4), dense)
    check(got.shape == (*pe.shape[:2], 4)
          and torch.isfinite(got).all().item(), "TP output shape or values")
    check(launched == 5 * TP_SHARDS, f"the TP forward launched K-B6 "
          f"{launched} times, not 5 per shard")
    # the sum over 4 shards runs in another order than K-B5's sum over 256
    # channels: rtol 1e-4, atol 1e-5 x the teacher's raw scale
    for what, ref in (("K-B5", want), ("the dense MLP", dense.reshape_as(got))):
        check(torch.allclose(got, ref, rtol=1e-4, atol=1e-5 * scale),
              f"TP forward off {what}: max |d| {maxabs(got, ref)} at raw "
              f"scale {scale}")
    seen = []
    with held_against_plain("fused_pair", mlp_tp_fused.fused_pair_plain, seen,
                            module=mlp_tp_fused), torch.no_grad():
        again = mlp_tp_fused.fused_nerf_mlp_tp(model, pe, ve, mesh)
    check(torch.equal(again, got), "two TP forwards differ")
    check(len(seen) == 5 * TP_SHARDS and {r[0] for r in seen} == {n},
          f"held {len(seen)} launches of {sorted({r[0] for r in seen})} points")
    worst = max(r[1] / (1e-4 * r[3] + 1e-5) for r in seen)
    check(worst <= 1.0, f"K-B6 at the forward's tensors: {seen}")
    print(f"[12] TP slice, mesh {mesh.shape} of {dev}, {n} points (first "
          f"launch of a {H}x{W} NDC view): max|draw| {err:.3e} against K-B5, "
          f"{err_dense:.3e} against the dense MLP (raw scale {scale:.1f}); "
          f"{launched} K-B6 launches; each held against its plain version "
          f"on the forward's tensors: max|d| {max(r[1] for r in seen):.3e}, "
          f"at most {worst:.3f} of its bound")

    # tools/tp_mlp_bench.py's question on this card: one shard's compute
    # alone (the sum over shards as the identity) against K-B5's time / M
    m_pts = N_POINTS
    pe_s = pe.reshape(-1, 63)[:m_pts].contiguous()
    ve_s = ve.reshape(-1, 27)[:m_pts].contiguous()
    packed = mlp_fused.pack_weights(model)
    packed_mma = mlp_fused.repack_mma(packed)
    kb5_ms = cuda_ms(lambda: mlp_fused.mlp_embedded(packed, pe_s, ve_s,
                                                    packed_mma))
    alone = lambda parts, devices: {devices[0]: parts[0]}
    with torch.no_grad():
        for m in (1, 2, 4):
            shards, reps = mlp_tp_fused.place_tp_weights(model, [dev] * m)
            ms = cuda_ms(lambda: mlp_tp_fused._tp_forward(
                {dev: (pe_s, ve_s)}, shards[:1], reps, psum=alone))
            print(f"[12] TP shard M={m}, {m_pts} points (5 pair calls + the "
                  f"replicated torch pieces, no sum over shards): {ms:.3f} "
                  f"ms against K-B5 {kb5_ms:.3f} ms / {m} = "
                  f"{kb5_ms / m:.3f} ms")
        full_ms = cuda_ms(lambda: mlp_tp_fused.fused_nerf_mlp_tp(
            model, pe_s, ve_s, mesh))
    print(f"[12] the whole TP forward on the mesh of {TP_SHARDS} x {dev}, "
          f"{m_pts} points: {full_ms:.3f} ms (all shards on one card, one "
          f"after the other)")
    return launched


def phase_multi_device(dev, scene, dec0, sets):
    """The multi-device slice on meshes of 4 x cuda:0."""
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    graft_entry.dryrun_multichip(4)
    torch.cuda.synchronize()
    t_dry = time.perf_counter() - t0
    dry = _build.launch_counts()
    check(dry["mlp_tp_pair"] == 10 and dry["render_pass"] > 0,
          f"dryrun_multichip(4) launches: {dry}")
    print(f"[13] dryrun_multichip(4) on 4 x {dev} in {t_dry:.1f} s; launches "
          f"{ {k: v for k, v in dry.items() if v} }")

    # data-parallel LSA against the single-device run, the same batches and
    # draws, from the qp=-20 decode without LSA
    ex = presets.create_nerf_model_executer(scene=scene, device=dev,
                                            use_fused_mlp=True,
                                            learning_rate=LSA_LR,
                                            verbose=False)
    mesh = parallel.make_mesh(4, ("data",))
    draws = lambda i: sets[i]
    _build.reset_launch_counts()
    ls_1, ms_1 = _lsa_run(ex, *ex._split_params(dec0), draws)
    one = _build.launch_counts()
    _build.reset_launch_counts()
    ls_4, ms_4 = _lsa_run(ex, *ex._split_params(dec0), draws, mesh=mesh)
    four = _build.launch_counts()
    # one device: a graph of 8 steps (its warm-up step launches too) and
    # two single steps; the mesh runs every step eagerly on 4 shards
    check(all(one[k] == 2 * (TRAJ_STEPS + lsa.WARMUP_STEPS)
              and four[k] == 4 * 2 * TRAJ_STEPS for k in LSA_KERNELS),
          f"K-B1 launches: one device {one}, mesh {four}")
    drift = float((ls_4 - ls_1).abs().max())
    span = float((ls_1 - 1.0).abs().max())
    print(f"[13] data-parallel LSA, {TRAJ_STEPS} steps, N_rand 1024 on mesh "
          f"{mesh.shape} of {dev}: max |d scale| {drift:.3e} against the "
          f"single-device run (max |ls-1| {span:.3e}); mean step "
          f"{ms_4:.2f} ms on the mesh, {ms_1:.2f} ms on one device; K-B1 "
          f"launches {four['mlp_train_fwd']} + {four['mlp_train_bwd']} "
          f"against {one['mlp_train_fwd']} + {one['mlp_train_bwd']}")
    # the CPU test's tolerance (tests/test_torch_port_parallel.py (d))
    check(span > 0 and torch.allclose(ls_4, ls_1, rtol=1e-4, atol=1e-6),
          f"mesh LSA scales off the single-device run by {drift}")
    launches = {k: four[k] for k in LSA_KERNELS}

    # one test view through render_image(mesh=) against no mesh
    model_c, model_f = ex._split_params(dec0)
    H, W, K = scene["H"], scene["W"], np.asarray(scene["K"], np.float32)
    ro, rd = get_rays_np(H, W, K, scene["poses"][scene["i_test"][0]][:3, :4])
    exact = dataclasses.replace(ex.rc, early_term_eps=0.0, empty_ray_eps=0.0)
    for what, rc, limit in (("culling and early termination off", exact, 0.0),
                            ("the preset's culling and early termination",
                             ex.rc, 5e-3)):
        times = {}
        for how, rc_1 in (("kernels", rc), ("plain", dataclasses.replace(
                rc, use_fused_mlp=False, use_fused_compositing=False))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one = renderer.render_image(model_c, model_f, ro, rd,
                                        scene["near"], scene["far"], rc_1)
            torch.cuda.synchronize()
            times[how] = time.perf_counter() - t0
            if how == "kernels":
                single = one
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        multi = renderer.render_image(model_c, model_f, ro, rd,
                                      scene["near"], scene["far"], rc,
                                      mesh=mesh)
        torch.cuda.synchronize()
        t_view = time.perf_counter() - t0
        n_kb2 = _build.launch_counts()["render_pass"]
        d_rgb = maxabs(multi["rgb_map"], single["rgb_map"])
        print(f"[13] {H}x{W} view through render_image(mesh=) with {what}: "
              f"max|d rgb| {d_rgb:.3e} against the view without a mesh "
              f"(bound {limit:g}); {t_view:.2f} s, {n_kb2} K-B2 launches; "
              f"without a mesh {times['kernels']:.2f} s through the kernels, "
              f"{times['plain']:.2f} s plain")
        check(multi["rgb_map"].shape == (H, W, 3)
              and torch.isfinite(multi["rgb_map"]).all().item(),
              "mesh view shape or values")
        # rays are grouped into culling and termination tiles within each
        # shard: with both off every ray's result is its own (equal bits);
        # with them on, the reference's bound for a culled render against
        # the exact one
        check(d_rgb <= limit, f"mesh view off the single-device view by "
              f"{d_rgb} with {what}")
        # 2 passes x 4 shards per chunk of 32,768 rays
        check(n_kb2 == 8 * -(-H * W // rc.chunk), f"{n_kb2} K-B2 launches")
    launches["render_pass"] = n_kb2

    # joint LSA of 2 scenes (the same images, other batches) on a
    # ('scene', 'data') mesh against each scene tuned alone
    n_ms = 3
    scene_mesh = multi_scene.make_scene_mesh(2, 4)
    ex_b = presets.create_nerf_model_executer(scene=scene, device=dev,
                                              use_fused_mlp=True,
                                              verbose=False)
    ex_b.seed = ex.seed + 1
    batcher = lambda i: (ex, ex_b)[i]._make_batcher()
    _build.reset_launch_counts()
    tuned, psnrs = multi_scene.tune_multi_scene(
        [scene, scene], [ex._split_params(dec0) for _ in range(2)], ex.rc,
        batchers=[batcher(i) for i in range(2)], learning_rate=LSA_LR,
        n_iters=n_ms, mesh=scene_mesh, seed=9, verbose=False)
    torch.cuda.synchronize()
    joint = _build.launch_counts()
    check(all(joint[k] == 2 * 2 * 2 * n_ms for k in LSA_KERNELS),
          f"joint multi-scene K-B1 launches: {joint}")
    worst = 0.0
    for i, seed_i in enumerate(multi_scene.scene_seeds(9, 2)):
        alone, psnr = multi_scene.tune_multi_scene(
            [scene], [ex._split_params(dec0)], ex.rc, batchers=[batcher(i)],
            learning_rate=LSA_LR, n_iters=n_ms, seeds=[seed_i],
            verbose=False)
        for joint_s, seq_s in zip(tuned[i], alone[0]):
            for name in seq_s:
                worst = max(worst, maxabs(joint_s[name], seq_s[name]))
                check(torch.allclose(joint_s[name], seq_s[name], rtol=2e-4,
                                     atol=2e-6),
                      f"scene {i} scale {name}: joint and sequential differ "
                      f"by {maxabs(joint_s[name], seq_s[name])}")
        check(abs(psnrs[i] - psnr[0]) < 0.05, f"scene {i} PSNR joint "
              f"{psnrs[i]}, alone {psnr[0]}")
    print(f"[13] joint LSA of 2 scenes, {n_ms} steps on mesh "
          f"{scene_mesh.shape} of {dev}: max |d scale| {worst:.3e} against "
          f"each scene alone (rtol 2e-4, atol 2e-6); last-step PSNR "
          f"{[round(p, 3) for p in psnrs]}")
    return launches, dry["mlp_tp_pair"]


def rms(t):
    return float(t.double().pow(2).mean().sqrt())


def held_to_bf16_distance(what, got, plain16, plain32):
    """A bf16 kernel's output against its plain bf16 version, in units of
    the distance between the plain bf16 and the plain float32 version on the
    same inputs (one float32 sum that falls the other way flips a bf16
    rounding, 2^-8 of an activation, so no absolute tolerance means
    anything): rms error <= 1/8 of the distance's rms, no element beyond the
    distance's max and at most 1e-4 of them beyond half of it (a few hundred
    points stay under half; over 10^5 the largest flips reach it), and the
    kernel three times closer (rms) to the plain bf16 version than to the
    float32 one. Returns (rms err, max err, rms distance, max distance)."""
    err, dist = got - plain16, plain16 - plain32
    e_rms, e_max = rms(err), float(err.abs().max())
    d_rms, d_max = rms(dist), float(dist.abs().max())
    beyond = float((err.abs() > d_max / 2).float().mean())
    check(torch.isfinite(got).all().item(), f"{what}: output not finite")
    check(d_rms > 0 and e_rms <= d_rms / 8, f"{what}: rms error {e_rms} "
          f"against a bf16-to-float32 rms of {d_rms}")
    check(e_max <= d_max and beyond <= 1e-4, f"{what}: max error {e_max} "
          f"against a bf16-to-float32 max of {d_max}, {beyond} of the "
          f"elements beyond half of it")
    check(3 * e_rms <= rms(got - plain32), f"{what}: not three times closer "
          f"to the plain bf16 version than to the float32 one")
    return e_rms, e_max, d_rms, d_max


def phase_bf16_kernels(dev, ctx):
    """Phase 14: K-B3 bf16 and K-B2 bf16 against their plain bf16 versions."""
    lib = _build.lib()
    check(lib.nnc_bf16_params_size() == mlp_fused.BF16_PARAMS_SIZE
          and lib.nnc_bf16_tile_points()
          == render_fused.SLOTS_BF16 * render_fused.SAMPLE_BLOCK
          and lib.nnc_bf16_wgmma_size() == mlp_fused.WG_SIZE,
          "the bf16 kernels' and the packing's sizes differ")
    ops = library_opcodes("mlp_from_points_bf16_kernel")
    check(ops["HGMMA"] > 0 and ops["HMMA"] == 0,
          f"K-B3 bf16's SASS: HGMMA {ops['HGMMA']}, HMMA {ops['HMMA']} "
          f"(warpgroup products only, no mma.sync loop expected)")
    packed, packed_mma = ctx["packed"], ctx["packed_mma"]
    pts, vd, n = ctx["pts"], ctx["vd"], ctx["pts"].shape[0]
    buf = mlp_fused.repack_bf16(packed)
    check(torch.equal(buf, mlp_fused.pack_weights_bf16(ctx["model"])),
          "repack_bf16 and pack_weights_bf16 differ")
    wg = mlp_fused.repack_bf16_wgmma(buf)
    run = lambda p=pts, v=vd: mlp_fused.mlp_from_points_bf16(buf, p, v,
                                                             packed_wg=wg)
    plain = lambda p=pts, v=vd: \
        mlp_fused.fused_nerf_mlp_from_points_bf16_plain(buf, p, v)
    got = run()
    torch.cuda.synchronize()
    e_rms, e_max, d_rms, d_max = held_to_bf16_distance(
        f"K-B3 bf16 {n} points", got, plain(), ctx["raw_plain"])
    check(torch.equal(run(), got), "K-B3 bf16 reruns differ")
    g = torch.Generator().manual_seed(14)
    ragged = {}
    for m in RAGGED:
        p = (4 * torch.rand(m, 3, generator=g) - 2).to(dev)
        v = vd[torch.randint(n, (m,), generator=g).to(dev)].contiguous()
        ragged[m] = held_to_bf16_distance(
            f"K-B3 bf16 {m} points", run(p, v), plain(p, v),
            mlp_fused.fused_nerf_mlp_from_points_plain(packed, p, v))
    f32 = lambda: mlp_fused.mlp_from_points(packed, pts, vd, packed_mma)
    times = [[cuda_ms(fn) for fn in (run, f32, plain)] for _ in range(2)]
    ms, f32_ms, plain_ms = (min(t) for t in zip(*times))
    flop = 2 * MLP_MACS * n
    rows = {"mlp_from_points_bf16": {
        "max_abs_err": e_max, "ms": ms, "plain_ms": plain_ms,
        **bound(nbytes(buf, pts, vd, got), flop, PEAK_BF16),
        "peak_tflops": PEAK_BF16 / 1e12}}
    b = rows["mlp_from_points_bf16"]
    print(f"[14] K-B3 bf16 {n} points against its plain bf16 version: rms "
          f"{e_rms:.3e} max {e_max:.3e}; bf16-to-float32 distance rms "
          f"{d_rms:.3e} max {d_max:.3e} ({e_rms / d_rms:.3f} / "
          f"{e_max / d_max:.3f} of it); ragged "
          f"{ {m: f'{r[0] / r[2]:.3f} / {r[1] / r[3]:.3f}' for m, r in ragged.items()} }"
          f", reruns bit-equal")
    print(f"     in turns, ms: K-B3 bf16 {[f'{t[0]:.3f}' for t in times]}, "
          f"K-B3 float32 {[f'{t[1]:.3f}' for t in times]}, plain bf16 "
          f"{[f'{t[2]:.3f}' for t in times]}; {flop / ms / 1e9:.1f} TFLOP/s, "
          f"bound {b['bound_ms']:.3f} ms by {b['bound_by']} at "
          f"{PEAK_BF16 / 1e12:.0f} TFLOP/s: {100 * b['bound_ms'] / ms:.1f}% "
          f"reached; the mma.sync kernel it replaced (PERF.md): "
          f"{REPLACED_MS['mlp_from_points_bf16']:.3f} ms; SASS HGMMA "
          f"{ops['HGMMA']}, HMMA {ops['HMMA']}")

    R, rt = N_RAYS, render_fused.RAY_TILE_BF16
    for model, rays, S, want_w in render_cases(dev):
        ro, rd, vd_r, z, dists, live = rays
        packed_r = mlp_fused.pack_weights(model)
        mma_r = mlp_fused.repack_mma(packed_r)
        buf_r = mlp_fused.repack_bf16(packed_r)
        raw = mlp_fused.mlp_from_points_bf16(
            buf_r, (ro[:, None, :] + rd[:, None, :] * z[..., None])
            .reshape(-1, 3).contiguous(),
            vd_r[:, None, :].expand(R, S, 3).reshape(-1, 3).contiguous())
        before = optical_depth_before(raw, dists)
        for eps in (0.0, 1e-4):
            term = -math.log(eps) if eps > 0 else math.inf
            tail = (ro, rd, vd_r, z, dists, live, term, want_w)
            run = lambda: render_fused.render_pass_bf16(buf_r, *tail)
            maps, w = run()
            torch.cuda.synchronize()
            maps_p, w_p = render_fused.fused_render_pass_bf16_plain(buf_r,
                                                                    *tail)
            # the float32 plain version stopping each ray alone, as the kernel
            maps_f, w_f = render_fused.fused_render_pass_plain(
                packed_r, *tail, ray_tile=rt)
            # (rgb / acc of a solid scene differ by float32 rounding alone:
            # phase 3's tolerance of the float32 compositing is the floor)
            parts = [("rgb/acc", maps[:, :4], maps_p[:, :4], maps_f[:, :4],
                      2 * eps + 1e-5),
                     ("depth", maps[:, 4], maps_p[:, 4], maps_f[:, 4],
                      2 * eps * 6.0)]
            if want_w:
                parts.append(("weights", w, w_p, w_f, 2 * eps))
            shown = []
            for name, a, b_, c, slack in parts:
                err, dist = maxabs(a, b_), maxabs(b_, c)
                shown.append(f"{name} {err:.3e} of {dist:.3e}")
                # half the bf16-to-float32 distance of the same maps, and
                # with early termination on the 2 eps by which both
                # versions may differ at a threshold tie
                check(dist > 0 and err <= dist / 2 + slack,
                      f"K-B2 bf16 S={S} eps={eps}: {name} off its plain "
                      f"version by {err}, bf16-to-float32 distance {dist}")
            check(torch.isfinite(maps).all().item(),
                  "K-B2 bf16 maps not finite")
            check(float(maps[live == 0].abs().max()) == 0.0,
                  "K-B2 bf16 dead tiles not zero")
            maps_2, w_2 = run()
            check(torch.equal(maps_2, maps)
                  and (not want_w or torch.equal(w_2, w)),
                  "K-B2 bf16 reruns differ")
            f32_run = lambda: render_fused.render_pass(packed_r, *tail,
                                                       packed_mma=mma_r)
            plain_run = lambda: render_fused.fused_render_pass_bf16_plain(
                buf_r, *tail)
            ms, f32_ms, plain_ms = (cuda_ms(fn)
                                    for fn in (run, f32_run, plain_run))
            needed, computed = points_of(before, live, term, rt)
            # what tiles of four rays computed (the kernel this one replaced)
            _, in_fours = points_of(before, live, term, 4)
            b = bound(nbytes(buf_r, ro, rd, vd_r, z, dists, live, maps),
                      2 * MLP_MACS * needed, PEAK_BF16)
            print(f"[14] K-B2 bf16 {R} rays S={S} weights={want_w} "
                  f"eps={eps}: max|d| against plain bf16, of the "
                  f"bf16-to-float32 distance: {', '.join(shown)}; reruns "
                  f"bit-equal; kernel {ms:.3f} ms, float32 kernel "
                  f"{f32_ms:.3f} ms, plain bf16 {plain_ms:.3f} ms; {needed} "
                  f"of {R * S} points needed ({computed} computed in blocks "
                  f"of {rt} ray, tiles of four rays {in_fours}, "
                  f"{2 * MLP_MACS * computed / ms / 1e9:.1f} TFLOP/s): "
                  f"{2 * MLP_MACS * needed / ms / 1e9:.1f} TFLOP/s, bound "
                  f"{b['bound_ms']:.3f} ms by {b['bound_by']} at "
                  f"{PEAK_BF16 / 1e12:.0f} TFLOP/s: "
                  f"{100 * b['bound_ms'] / ms:.1f}% reached")
            if S == 192 and eps > 0:
                print(f"     per ray on a queue: {computed} points computed, "
                      f"{ms:.3f} ms; tiles of four rays (the kernel it "
                      f"replaced; PERF.md): {REPLACED_POINTS_BF16} points, "
                      f"{REPLACED_MS['render_pass_bf16']:.3f} ms")
                rows["render_pass_bf16"] = {
                    "max_abs_err": maxabs(maps[:, :4], maps_p[:, :4]),
                    "ms": ms, "plain_ms": plain_ms, **b,
                    "peak_tflops": PEAK_BF16 / 1e12}
    return rows


def phase_bf16_slice(dev, scene, dec, psnr_f32, scene_ndc, sd_ndc, tar):
    """Phase 15: the bf16 serving slice at full width, on phase 4's scene and
    decoded weights and phase 5's NDC scene."""
    bf16 = nerf.NeRFConfig(compute_dtype=torch.bfloat16)
    make = lambda sc, **kw: presets.create_nerf_model_executer(
        scene=sc, device=dev, verbose=False, **kw)
    ex = make(scene, mlp_config=bf16, use_fused_mlp=True)
    ex_plain = make(scene, mlp_config=bf16, use_fused_mlp=False)
    ex_f32 = make(scene, use_fused_mlp=True)
    check(ex.rc.mlp.compute_dtype == torch.bfloat16
          and ex.rc.use_fused_compositing, "the bf16 config did not reach "
          "the executer's render config")

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _build.reset_launch_counts()
    psnr, t_view = timed(ex.test_model, dec)
    counts = _build.launch_counts()
    psnr_plain, t_plain = timed(ex_plain.test_model, dec)
    check(_build.launch_counts() == counts,
          "the plain bf16 path launched a kernel")
    _p, t_f32 = timed(ex_f32.test_model, dec)
    n_chunks = -(-scene["H"] * scene["W"] // ex.rc.chunk)
    check(counts["render_pass_bf16"] == 2 * n_chunks * len(scene["i_test"])
          and counts["render_pass"] == 0 and counts["mlp_from_points"] == 0,
          f"bf16 test_model launches: {counts}")
    launches = {"render_pass_bf16": counts["render_pass_bf16"]}

    # pixel by pixel: the test view through the bf16 kernels, the float32
    # kernels and the plain bf16 path
    view = scene["i_test"][:1]
    split = ex._split_params(dec)
    img = ex._render_views(*split, view)[0][0]
    img_plain = ex_plain._render_views(*split, view)[0][0]
    img_f32 = ex_f32._render_views(*ex_f32._split_params(dec), view)[0][0]
    gt = scene["images"][view[0]]
    psnr_of = lambda a, keep: -10.0 * math.log10(
        float(np.mean((a[keep] - gt[keep]) ** 2)))
    d_f32 = np.abs(img - img_f32).max(-1)
    d_plain = np.abs(img - img_plain).max(-1)
    # a pixel whose ray grazes the solid takes other fine samples when one
    # coarse weight moves (sample_pdf, ROADMAP C): bf16 moves such a pixel by
    # 1e-2 and more, every other by its own rounding noise
    jumped = d_f32 > 1e-2
    steady = ~jumped
    psnr_s, psnr_s_f32, psnr_s_plain = (psnr_of(a, steady)
                                        for a in (img, img_f32, img_plain))
    print(f"[15] bf16 serving slice {LEGO_HW}x{LEGO_HW}: decoded test PSNR "
          f"through the bf16 kernels {psnr:.4f} dB, plain bf16 "
          f"{psnr_plain:.4f} dB, float32 kernels {psnr_f32:.4f} dB; one "
          f"view: max|d rgb| {d_f32.max():.3e} from the float32 kernels' "
          f"(rms {np.sqrt((d_f32 ** 2).mean()):.3e}, {int(jumped.sum())} of "
          f"{jumped.size} pixels beyond 1e-2), {d_plain.max():.3e} from the "
          f"plain bf16 path's (rms {np.sqrt((d_plain ** 2).mean()):.3e}, "
          f"{int((d_plain > 1e-2).sum())} beyond 1e-2); PSNR over the "
          f"{int(steady.sum())} other pixels: bf16 kernels {psnr_s:.4f}, "
          f"float32 kernels {psnr_s_f32:.4f}, plain bf16 {psnr_s_plain:.4f} "
          f"dB")
    print(f"     launches {counts['render_pass_bf16']} K-B2 bf16, 0 float32; "
          f"test_model (one view): bf16 kernels {t_view:.2f} s, float32 "
          f"kernels {t_f32:.2f} s, plain bf16 {t_plain:.2f} s")
    check(all(np.isfinite([psnr, psnr_plain, psnr_s])) and
          np.isfinite(img).all(), "bf16 PSNR or image not finite")
    check(psnr > 20.0, f"bf16 decoded test PSNR {psnr} dB")
    # within 0.1 dB of the float32 kernels' render and of the plain bf16
    # render, away from the pixels that jump, which must be few
    check(jumped.sum() <= 1e-3 * jumped.size
          and abs(psnr_s - psnr_s_f32) <= 0.1
          and abs(psnr_s - psnr_s_plain) <= 0.1,
          f"bf16 render: {int(jumped.sum())} pixels jump, PSNR elsewhere "
          f"{psnr_s} dB against float32 {psnr_s_f32} dB, plain bf16 "
          f"{psnr_s_plain} dB")

    # the NDC scene (raw_noise_std = 1): K-B3 bf16
    ex_ndc = make(scene_ndc, mlp_config=bf16, use_fused_mlp=True)
    _build.reset_launch_counts()
    psnr_ndc, t_ndc = timed(ex_ndc.test_model, sd_ndc)
    counts = _build.launch_counts()
    psnr_ndc_plain, t_ndc_plain = timed(
        make(scene_ndc, mlp_config=bf16, use_fused_mlp=False).test_model,
        sd_ndc)
    check(counts["mlp_from_points_bf16"] > 0
          and counts["mlp_from_points"] == 0 and counts["render_pass"] == 0,
          f"bf16 NDC test_model launches: {counts}")
    launches["mlp_from_points_bf16"] = counts["mlp_from_points_bf16"]
    print(f"[15] NDC {FERN_HW[0]}x{FERN_HW[1]}, 64+64 through K-B3 bf16: "
          f"teacher test PSNR {psnr_ndc:.2f} dB in {t_ndc:.2f} s, "
          f"{counts['mlp_from_points_bf16']} launches; plain bf16 "
          f"{psnr_ndc_plain:.2f} dB in {t_ndc_plain:.2f} s")
    check(np.isfinite(psnr_ndc) and psnr_ndc > 30.0
          and abs(psnr_ndc - psnr_ndc_plain) <= 1.0,
          f"NDC render through K-B3 bf16 {psnr_ndc} dB, plain bf16 "
          f"{psnr_ndc_plain} dB")

    # IOQ with the probe rendering in bf16
    bs = os.path.join(OUT, "teacher_bf16_probe.nnc")
    _build.reset_launch_counts()
    before = _build.launch_counts()
    _none, t_compress = timed(lambda: nnc_tpu_torch.compress_model(
        tar, bitstream_path=bs, qp=-20, lsa=False, ioq=True, scene=scene,
        mlp_config=bf16, use_fused_mlp=True, device=dev, verbose=False))
    after = _build.launch_counts()
    check(after["render_pass_bf16"] > before["render_pass_bf16"]
          and after["render_pass"] == before["render_pass"],
          "the bf16 IOQ probe did not run K-B2 bf16")
    launches["render_pass_bf16"] += \
        after["render_pass_bf16"] - before["render_pass_bf16"]
    dec_b = nnc_tpu_torch.decompress_model(bs, verbose=False)
    psnr_b = ex.test_model(dec_b)
    moved = sum(not np.array_equal(dec_b[k], dec[k]) for k in dec)
    print(f"[15] compress_model(ioq=True, mlp_config=bf16): "
          f"{os.path.getsize(bs)} B (107,599 B with the float32 probe; "
          f"{moved} of {len(dec)} decoded tensors differ) in "
          f"{t_compress:.1f} s, "
          f"{after['render_pass_bf16'] - before['render_pass_bf16']} K-B2 "
          f"bf16 launches; decoded test PSNR through the bf16 kernels "
          f"{psnr_b:.4f} dB")
    check(set(dec_b) == set(dec) and np.isfinite(psnr_b) and psnr_b > 20.0,
          f"the bf16-probed bitstream decodes to {psnr_b} dB")

    fn, args = graft_entry.entry()
    check(args[0].config.compute_dtype == torch.bfloat16,
          "graft_entry.entry() is not bf16")
    rgb, t_entry = timed(fn, *args)
    check(rgb.shape == (1024, 3) and torch.isfinite(rgb).all().item(),
          "graft_entry.entry() in bf16: shape or values")
    print(f"[15] graft_entry.entry() in bf16 (plain MLP, 1,024 rays, "
          f"64 + 128): finite, {t_entry:.2f} s")
    return launches, psnr_ndc


def grads_to_bf16_distance(what, flat, flat16, flat32, with_dw):
    """Each part of a bf16 K-B1 gradient (dW with_dw, dls, db, over all
    layers) against the plain bf16 version's, in units of the distance
    between the plain bf16 and the plain float32 gradient: rms error <= 1/4
    of the distance's rms, no element beyond 1/2 of its max (dW besides one
    bf16 step, 2^-7 of the value: both round it once summed, and a last-bit
    difference of the sum moves it by a step), and three times closer (rms)
    to the plain bf16 gradient than to the float32 one. Measured on an H100
    at 196,608 points: 0.06-0.07 of the rms, 0.07-0.09 of the max. Returns
    {part: (rms err / rms dist, max err / max dist)}."""
    parts = zip(("dW", "dls", "db"),
                *(mlp_train_fused.split_grads(f, with_dw)
                  for f in (flat, flat16, flat32)))
    out = {}
    for part, got, want16, want32 in parts:
        if got is None:
            continue
        got, want16, want32 = (torch.cat([v.reshape(-1) for v in d.values()])
                               for d in (got, want16, want32))
        err, dist = got - want16, want16 - want32
        step = 2.0 ** -7 * want16.abs() if part == "dW" else 0.0
        e_rms, d_rms = rms(err), rms(dist)
        e_max = float((err.abs() - step).max())
        d_max = float(dist.abs().max())
        check(torch.isfinite(got).all().item(), f"{what} {part} not finite")
        check(d_rms > 0 and e_rms <= d_rms / 4 and e_max <= d_max / 2
              and 3 * e_rms <= rms(got - want32),
              f"{what} {part}: rms error {e_rms} and max {e_max} against a "
              f"bf16-to-float32 distance of rms {d_rms}, max {d_max}")
        out[part] = (e_rms / d_rms, e_max / d_max)
    return out


def phase_train_bf16_kernels(dev):
    """Phase 16: K-B1 bf16 against its plain bf16 versions."""
    sizes = [ctypes.c_int() for _ in range(3)]
    _build.lib().nnc_train_bf16_sizes(*(ctypes.byref(c) for c in sizes))
    check([c.value for c in sizes] == [
        mlp_train_fused.TILE_BF16, mlp_fused.BF16_PARAMS_SIZE,
        mlp_train_fused.BWD_BF16_PARAMS_SIZE],
        f"the bf16 K-B1 kernels' and the packing's sizes differ: "
        f"{[c.value for c in sizes]}")
    g = torch.Generator().manual_seed(16)
    model = nerf.init_params(nerf.NeRFConfig(), g)
    model = synthetic._activate(model, g)
    model = nerf.init_lsa_scales(model, std=0.05, generator=g).to(dev)
    tensors = mlp_train_fused._layer_tensors(model)
    params, params_t, ls = mlp_train_fused.pack_train(
        tensors[0::3], tensors[1::3], tensors[2::3])
    # what the kernels read: the bf16 streams of the unscaled weights and
    # the bias vector, as fused_nerf_mlp_train hands them over
    fwd_b, bwd_b = mlp_train_fused.pack_train_bf16(tensors[0::3])
    wg, wg_t = mlp_train_fused.pack_train_wgmma(tensors[0::3])
    biases = mlp_train_fused.gather_biases(params)
    rows = None
    for n in N_TRAIN:
        pts = (4 * torch.rand(n, 3, generator=g) - 2).to(dev)
        vd = torch.randn(n, 3, generator=g)
        vd = (vd / torch.linalg.norm(vd, dim=-1, keepdim=True)).to(dev)
        cot = (1e-3 * torch.randn(n, 4, generator=g)).to(dev)
        fwd = lambda: mlp_train_fused.mlp_train_fwd_bf16(
            params, ls, pts, vd, True, fwd_b, biases)
        raw, ws = fwd()
        torch.cuda.synchronize()
        raw16 = mlp_train_fused.mlp_train_fwd_bf16_plain(params, ls, pts, vd)
        raw32 = mlp_train_fused.mlp_train_fwd_plain(params, ls, pts, vd)
        f_rms, f_max, fd_rms, fd_max = held_to_bf16_distance(
            f"K-B1 bf16 forward {n} points", raw, raw16, raw32)
        raw_2, ws_2 = fwd()
        made = mlp_train_fused.mlp_train_fwd_bf16(params, ls, pts, vd,
                                                  save_u=True)
        unsaved = mlp_train_fused.mlp_train_fwd_bf16(params, ls, pts, vd,
                                                     False, fwd_b, biases)
        check(torch.equal(raw_2, raw) and torch.equal(ws_2, ws)
              and torch.equal(made[0], raw) and torch.equal(made[1], ws)
              and torch.equal(unsaved[0], raw) and unsaved[1] is None,
              "K-B1 bf16 forward: reruns, given and made buffers, or the "
              "forward without the workspace differ")
        del raw_2, ws_2, made, unsaved
        err = {}
        for with_dw in (False, True):
            bwd = lambda: mlp_train_fused.mlp_train_bwd_bf16(
                params, params_t, ls, pts, vd, cot, ws, with_dw, bwd_b,
                biases)
            flat = bwd()
            torch.cuda.synchronize()
            err[with_dw] = grads_to_bf16_distance(
                f"K-B1 bf16 backward {n} points with_dw={with_dw}", flat,
                mlp_train_fused.mlp_train_bwd_bf16_plain(
                    params, params_t, ls, pts, vd, cot, with_dw),
                mlp_train_fused.mlp_train_bwd_plain(
                    params, params_t, ls, pts, vd, cot, with_dw), with_dw)
            check(torch.equal(bwd(), flat), "K-B1 bf16 backward reruns "
                  f"differ (with_dw={with_dw})")
        print(f"[16] K-B1 bf16 {n} points against its plain bf16 versions, "
              f"in shares (rms / max) of the bf16-to-float32 distance: raw "
              f"{f_rms / fd_rms:.3f} / {f_max / fd_max:.3f} (distance rms "
              f"{fd_rms:.3e} max {fd_max:.3e}); gradients without dW "
              f"{ {k: f'{a:.3f} / {b:.3f}' for k, (a, b) in err[False].items()} }"
              f", with dW "
              f"{ {k: f'{a:.3f} / {b:.3f}' for k, (a, b) in err[True].items()} }"
              f"; reruns bit-equal")
        if n != N_TRAIN[-1]:
            del ws
            continue
        # in turns: the bf16 kernel, the float32 kernel, the plain bf16
        # version (which recomputes the forward in its backward)
        _raw32, ws32 = mlp_train_fused.mlp_train_fwd(params, ls, pts, vd,
                                                     True, wg, biases)
        fns = {
            "mlp_train_fwd_bf16": (
                fwd,
                lambda: mlp_train_fused.mlp_train_fwd(params, ls, pts, vd,
                                                      True, wg, biases),
                lambda: mlp_train_fused.mlp_train_fwd_bf16_plain(
                    params, ls, pts, vd)),
            "mlp_train_bwd_bf16": (
                lambda: mlp_train_fused.mlp_train_bwd_bf16(
                    params, params_t, ls, pts, vd, cot, ws, False, bwd_b,
                    biases),
                lambda: mlp_train_fused.mlp_train_bwd(
                    params, params_t, ls, pts, vd, cot, ws32, False, wg_t,
                    biases),
                lambda: mlp_train_fused.mlp_train_bwd_bf16_plain(
                    params, params_t, ls, pts, vd, cot, False)),
            "mlp_train_bwd_dw_bf16": (
                lambda: mlp_train_fused.mlp_train_bwd_bf16(
                    params, params_t, ls, pts, vd, cot, ws, True, bwd_b,
                    biases),
                lambda: mlp_train_fused.mlp_train_bwd(
                    params, params_t, ls, pts, vd, cot, ws32, True, wg_t,
                    biases),
                lambda: mlp_train_fused.mlp_train_bwd_bf16_plain(
                    params, params_t, ls, pts, vd, cot, True))}
        # what each function must move and do: the workspace of u written
        # once by the forward and read once by a backward dominates the
        # bytes; the products of bf16 values at the dense bf16 peak
        flat = fns["mlp_train_bwd_bf16"][0]()
        flat_dw = fns["mlp_train_bwd_dw_bf16"][0]()
        bounds = {
            "mlp_train_fwd_bf16": bound(
                nbytes(fwd_b, ls, biases, pts, vd, raw, ws),
                2 * MLP_MACS * n, PEAK_BF16),
            "mlp_train_bwd_bf16": bound(
                nbytes(bwd_b, ls, biases, cot, ws, flat), 2 * BWD_MACS * n,
                PEAK_BF16),
            "mlp_train_bwd_dw_bf16": bound(
                nbytes(bwd_b, ls, biases, pts, vd, cot, ws, flat_dw),
                2 * (BWD_MACS + INT8_MACS) * n, PEAK_BF16)}
        errs = {"mlp_train_fwd_bf16": maxabs(raw, raw16),
                "mlp_train_bwd_bf16": maxabs(flat, mlp_train_fused
                                             .mlp_train_bwd_bf16_plain(
                                                 params, params_t, ls, pts,
                                                 vd, cot, False)),
                "mlp_train_bwd_dw_bf16": maxabs(
                    flat_dw, mlp_train_fused.mlp_train_bwd_bf16_plain(
                        params, params_t, ls, pts, vd, cot, True))}
        rows = {}
        for name, (kernel, f32, plain) in fns.items():
            it = 2 if "dw" in name else 5
            times = [[cuda_ms(fn, iters=it) for fn in (kernel, f32, plain)]
                     for _ in range(2)]
            ms, f32_ms, plain_ms = (min(t) for t in zip(*times))
            rows[name] = {"max_abs_err": errs[name], "ms": ms,
                          "plain_ms": plain_ms, **bounds[name],
                          "float32_ms": f32_ms}
            b = bounds[name]
            replaced = f"; the kernel it replaced " \
                f"{REPLACED_MS[name]:.3f} ms (PERF.md)" \
                if name in REPLACED_MS else ""
            print(f"[16] {name} {n} points, in turns, ms: kernel "
                  f"{[f'{t[0]:.3f}' for t in times]}, float32 K-B1 "
                  f"{[f'{t[1]:.3f}' for t in times]}, plain bf16 "
                  f"{[f'{t[2]:.3f}' for t in times]}; bound "
                  f"{b['bound_ms']:.3f} ms by {b['bound_by']}: "
                  f"{100 * b['bound_ms'] / ms:.1f}% reached{replaced}")
        del ws, ws32
    return rows


def _kb1_plain():
    """A block in which K-B1's wrappers run their plain versions on CUDA
    tensors (the pack cache handing out no kernel buffers, so that the
    autograd function packs for the plain versions): the reference of
    phase 17's trajectory. No kernel of K-B1 launches inside it."""
    stack = contextlib.ExitStack()

    class NoPacks:
        def get(self, *_args):
            return None

        def entries(self):
            return []

    def fwd(bf16, params, ls, pts, dirs, save_u, packed, biases):
        return mlp_train_fused._FORMS[bf16]["fwd_plain"](params, ls, pts,
                                                         dirs), None

    def bwd(bf16, params, params_t, ls, pts, dirs, g, ws, with_dw, packed_t,
            biases):
        return mlp_train_fused._FORMS[bf16]["bwd_plain"](
            params, params_t, ls, pts, dirs, g, with_dw)

    for name, fn in (("TRAIN_PACKS", NoPacks()), ("_fwd", fwd),
                     ("_bwd", bwd)):
        stack.enter_context(swapped(mlp_train_fused, name, fn))
    return stack


def phase_lsa_bf16(dev, scene, tar, dec0, sets, ls32, psnr_lsa32):
    """Phase 17: the bf16 LSA slice on phase 4's scene and teacher."""
    bf16 = nerf.NeRFConfig(compute_dtype=torch.bfloat16)
    lsa_dir = os.path.join(OUT, "lsa_bf16")
    bs = os.path.join(lsa_dir, "bitstream", "lego_lsa_bf16.nnc")
    os.makedirs(os.path.dirname(bs))
    steps = 40
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    nnc_tpu_torch.compress_model(
        tar, bitstream_path=bs, qp=-20, ioq=False, lsa=True, scene=scene,
        mlp_config=bf16, use_fused_mlp=True, learning_rate=LSA_LR,
        N_iters=steps // 2, epochs=2, i_save=steps // 2, render_factor=4,
        device=dev, verbose=False)
    torch.cuda.synchronize()
    t_compress = time.perf_counter() - t0
    counts = _build.launch_counts()
    dec = nnc_tpu_torch.decompress_model(bs, verbose=False)
    ex = presets.create_nerf_model_executer(scene=scene, device=dev,
                                            mlp_config=bf16,
                                            use_fused_mlp=True,
                                            learning_rate=LSA_LR,
                                            verbose=False)
    before = _build.launch_counts()
    psnr = ex.test_model(dec)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    _psnrs, loss_log = read_result_file(os.path.join(lsa_dir, "result.txt"))
    # every training render (coarse and fine of each step, and of the
    # warm-up step of the run's CUDA graph) through K-B1 bf16 and none
    # through the float32 pair; the i_save renders and the
    # test render through K-B2 bf16
    check(counts["mlp_train_fwd_bf16"] == counts["mlp_train_bwd_bf16"]
          == 2 * (steps + lsa.WARMUP_STEPS) and counts["mlp_train_fwd"] == 0
          and counts["mlp_train_bwd"] == 0
          and counts["mlp_train_bwd_dw_bf16"] == 0
          and counts["render_pass_bf16"] > 0 and counts["render_pass"] == 0
          and after["render_pass_bf16"] > before["render_pass_bf16"]
          and after["render_pass"] == before["render_pass"],
          f"bf16 LSA launches: {counts}, test render {after}")
    check(len(loss_log) == steps and np.isfinite(loss_log).all(),
          f"bf16 LSA losses: {len(loss_log)} logged")
    check(set(dec) == set(dec0) and np.isfinite(psnr) and psnr > 20.0,
          f"the bf16-tuned bitstream decodes to {psnr} dB")
    launches = {k: counts[k] for k in LSA_BF16_KERNELS}

    # TRAJ_STEPS steps from phase 7's no-LSA decode on its batches and
    # draws: through K-B1 bf16, through its plain bf16 versions, against
    # phase 7's plain float32 run
    ex_k = presets.create_nerf_model_executer(scene=scene, device=dev,
                                              mlp_config=bf16,
                                              use_fused_mlp=True,
                                              learning_rate=LSA_LR,
                                              verbose=False)
    draws = lambda i: sets[i]
    ls_k, ms_k = _lsa_run(ex_k, *ex_k._split_params(dec0), draws)
    before = _build.launch_counts()
    with _kb1_plain():
        ls_p, ms_p = _lsa_run(ex_k, *ex_k._split_params(dec0), draws)
    check(_build.launch_counts() == before,
          "the plain bf16 LSA run launched a kernel")
    err, dist = ls_k - ls_p, ls_p - ls32
    print(f"[17] bf16 LSA slice {LEGO_HW}x{LEGO_HW}, 64+128, N_rand 1024: "
          f"compress(lsa, {steps} steps, K-B1 bf16) {t_compress:.1f} s; test "
          f"PSNR {psnr:.4f} dB (float32, phase 7: {psnr_lsa32:.4f} dB); loss "
          f"{loss_log[0]:.3e} -> {loss_log[-1]:.3e}; launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    print(f"     {TRAJ_STEPS}-step trajectory: mean LSA step {ms_k:.2f} ms "
          f"through K-B1 bf16, {ms_p:.2f} ms through its plain versions; "
          f"|ls kernel - ls plain bf16| rms {rms(err):.3e} max "
          f"{float(err.abs().max()):.3e}, the plain bf16 run from the float32 "
          f"one rms {rms(dist):.3e} max {float(dist.abs().max()):.3e}, motion "
          f"rms {rms(ls_p - 1):.3e}")
    # Adam's steps follow the gradients' signs, and a channel whose
    # gradient is near zero flips with one rounding: the kernel's run is
    # held within 1/2 (rms) of the distance between the plain bf16 and the
    # float32 run, and twice as close to the plain bf16 run as to the
    # float32 one (tests/test_torch_port_train_bf16.py's bar)
    check(rms(dist) > 0 and rms(err) <= rms(dist) / 2
          and rms(ls_k - ls32) >= 2 * rms(err),
          f"K-B1 bf16 LSA trajectory: rms {rms(err)} from the plain bf16 run, "
          f"which lies rms {rms(dist)} from the float32 run")

    # the port's bench_train_step at full width, without and with dW, and
    # in float32 with dW
    bench = {}
    for key, argv, want in (
            ("bf16", [], {"mlp_train_fwd_bf16", "mlp_train_bwd_bf16"}),
            ("bf16 dW", ["--with_dw"], {"mlp_train_fwd_bf16",
                                        "mlp_train_bwd_dw_bf16"}),
            ("float32 dW", ["--with_dw", "--dtype", "float32"],
             {"mlp_train_fwd", "mlp_train_bwd_dw"})):
        _build.reset_launch_counts()
        bench[key] = bench_train_step.main(["--iters", "10"] + argv)
        counts = _build.launch_counts()
        fused = bench[key]["fused"]
        check(set(fused["launches"]) == want
              and all(np.isfinite([fused["loss"], bench[key]["plain"]["loss"]]))
              and {k for k, v in counts.items()
                   if v and k.startswith("mlp_train")} == want,
              f"bench_train_step {argv}: launches {counts}, fused path "
              f"{fused['launches']}")
        launches.update({k: launches.get(k, 0) + counts[k] for k in want})
    print(f"[17] bench_train_step (1,024 rays, 64+128, 10 steps), ms/it: "
          + "; ".join(f"{k}: plain {b['plain']['ms']:.2f}, K-B1 "
                      f"{b['fused']['ms']:.2f}" for k, b in bench.items()))
    return launches


def phase_bf16_tp_kernels(dev, ctx):
    """Phase 18: K-B5 bf16 and K-B6 bf16 against their plain bf16 versions,
    in units of the bf16-to-float32 distance (held_to_bf16_distance)."""
    model, packed, pts, vd = ctx["model"], ctx["packed"], ctx["pts"], ctx["vd"]
    n = pts.shape[0]
    buf = mlp_fused.pack_weights_bf16(model)
    pe = positional_encoding(pts, 10).contiguous()
    ve = positional_encoding(vd, 4).contiguous()
    run = lambda p=pe, v=ve: mlp_fused.mlp_embedded_bf16(buf, p, v)
    plain = lambda p=pe, v=ve: mlp_fused.fused_nerf_mlp_bf16_plain(buf, p, v)
    got = run()
    torch.cuda.synchronize()
    e_rms, e_max, d_rms, d_max = held_to_bf16_distance(
        f"K-B5 bf16 {n} points", got, plain(), ctx["raw_plain"])
    check(torch.equal(run(), got), "K-B5 bf16 reruns differ")
    # K-B3 bf16 on the points the embeddings were made of: its sincosf and
    # torch's sin / cos differ in the last bit of a few embedding values,
    # which may then round to the other bf16 neighbour
    wg = mlp_fused.repack_bf16_wgmma(buf)
    kb3 = lambda: mlp_fused.mlp_from_points_bf16(buf, pts, vd, packed_wg=wg)
    k_rms, k_max, *_ = held_to_bf16_distance(
        "K-B5 bf16 against K-B3 bf16", got, kb3(), ctx["raw_plain"])
    g = torch.Generator().manual_seed(18)
    ragged = {}
    for m in RAGGED:
        p = positional_encoding((4 * torch.rand(m, 3, generator=g) - 2)
                                .to(dev), 10).contiguous()
        v = ve[torch.randint(n, (m,), generator=g).to(dev)].contiguous()
        ragged[m] = held_to_bf16_distance(
            f"K-B5 bf16 {m} points", run(p, v), plain(p, v),
            mlp_fused.fused_nerf_mlp_plain(packed, p, v))
    f32 = lambda: mlp_fused.mlp_embedded(packed, pe, ve, ctx["packed_mma"])
    times = [[cuda_ms(fn) for fn in (run, kb3, f32, plain)] for _ in range(2)]
    ms, kb3_ms, f32_ms, plain_ms = (min(t) for t in zip(*times))
    flop = 2 * MLP_MACS * n
    rows = {"mlp_embedded_bf16": {
        "max_abs_err": e_max, "ms": ms, "plain_ms": plain_ms,
        **bound(nbytes(buf, pe, ve, got), flop, PEAK_BF16),
        "peak_tflops": PEAK_BF16 / 1e12, "float32_ms": f32_ms}}
    b = rows["mlp_embedded_bf16"]
    print(f"[18] K-B5 bf16 {n} points against its plain bf16 version: rms "
          f"{e_rms:.3e} max {e_max:.3e}; bf16-to-float32 distance rms "
          f"{d_rms:.3e} max {d_max:.3e} ({e_rms / d_rms:.3f} / "
          f"{e_max / d_max:.3f} of it); against K-B3 bf16 {k_rms / d_rms:.3f}"
          f" / {k_max / d_max:.3f} of it; ragged "
          f"{ {m: f'{r[0] / r[2]:.3f} / {r[1] / r[3]:.3f}' for m, r in ragged.items()} }"
          f", reruns bit-equal")
    print(f"     in turns, ms: K-B5 bf16 {[f'{t[0]:.3f}' for t in times]}, "
          f"K-B3 bf16 {[f'{t[1]:.3f}' for t in times]}, K-B5 float32 "
          f"{[f'{t[2]:.3f}' for t in times]}, plain bf16 "
          f"{[f'{t[3]:.3f}' for t in times]}; {flop / ms / 1e9:.1f} TFLOP/s, "
          f"bound {b['bound_ms']:.3f} ms by {b['bound_by']}: "
          f"{100 * b['bound_ms'] / ms:.1f}% reached (K-B3 bf16 {kb3_ms:.3f} "
          f"ms; the kernel that loaded its embedding between two tiles' "
          f"products {REPLACED_MS['mlp_embedded_bf16']:.3f} ms, PERF.md)")

    # K-B6 bf16 at phase 11's pair shapes; the float32 pair of the unrounded
    # operands is the far end of the distance
    shapes = [(TP_SHARDS, *head) for head in PAIR_HEADS] + \
        [(m, *head) for m in (1, 8) for head in PAIR_HEADS[:2]]
    for m, k, o2, relu_mid in shapes:
        s = 256 // m
        x, wa, ba, wb = _pair_inputs(n, k, s, o2, g, dev)
        args = (x, wa.bfloat16(), ba, wb.bfloat16(), relu_mid)
        run = lambda: mlp_tp_fused.fused_pair_bf16(*args)
        plain = lambda: mlp_tp_fused.fused_pair_bf16_plain(*args)
        f32 = lambda: mlp_tp_fused.fused_pair(x, wa, ba, wb, relu_mid)
        got = run()
        torch.cuda.synchronize()
        e_rms, e_max, d_rms, d_max = held_to_bf16_distance(
            f"K-B6 bf16 M={m} K={k} O2={o2}", got, plain(),
            mlp_tp_fused.fused_pair_plain(x, wa, ba, wb, relu_mid))
        check(torch.equal(run(), got), "K-B6 bf16 reruns differ")
        # the library's chain on the types the kernel reads and writes: x
        # cast to bf16, addmm on bf16 operands (cuBLAS sums in float32, its
        # output bf16, as the kernel rounds its hidden tile), relu, mm, the
        # result cast to float32
        ba16, wa16, wb16 = ba.bfloat16(), args[1], args[3]
        act = torch.relu if relu_mid else (lambda h: h)
        lib = lambda: torch.mm(act(torch.addmm(ba16, x.bfloat16(), wa16)),
                               wb16).float()
        times = [[cuda_ms(fn) for fn in (run, f32, plain, lib)]
                 for _ in range(2)]
        ms, f32_ms, plain_ms, cublas_ms = (min(t) for t in zip(*times))
        ops = 2 * n * s * (k + o2)
        b = bound(nbytes(*args[:4], got), ops, PEAK_BF16)
        print(f"[18] K-B6 bf16 {n} points M={m} K={k} S={s} O2={o2} "
              f"relu_mid={relu_mid}: {e_rms / d_rms:.3f} / "
              f"{e_max / d_max:.3f} of the bf16-to-float32 distance (rms "
              f"{d_rms:.3e}, max {d_max:.3e}), reruns bit-equal; kernel "
              f"{ms:.3f} ms ({ops / ms / 1e9:.2f} TFLOP/s), float32 kernel "
              f"{f32_ms:.3f} ms, plain bf16 {plain_ms:.3f} ms, cuBLAS bf16 "
              f"chain {cublas_ms:.3f} ms, bound {b['bound_ms']:.3f} ms by "
              f"{b['bound_by']} ({100 * b['bound_ms'] / ms:.1f}% reached)")
        if (m, k, o2) == (TP_SHARDS, 256, 256):
            rows["mlp_tp_pair_bf16"] = {
                "max_abs_err": e_max, "ms": ms, "plain_ms": plain_ms, **b,
                "peak_tflops": PEAK_BF16 / 1e12, "float32_ms": f32_ms,
                "cublas_bf16_ms": cublas_ms}
    return rows


def phase_bf16_tp_slice(dev, scene, sd, psnr_kb3_bf16):
    """Phase 19: the bf16 tensor-parallel forward and K-B5 bf16 on the
    renderer's chunks, on phase 5's NDC scene and teacher."""
    bf16 = nerf.NeRFConfig(compute_dtype=torch.bfloat16)
    make = lambda **kw: presets.create_nerf_model_executer(
        scene=scene, device=dev, use_fused_mlp=True, verbose=False, **kw)
    ex, ex32 = make(mlp_config=bf16), make()
    model, fine = ex._split_params(sd)
    model32, fine32 = ex32._split_params(sd)
    pe, ve = first_launch_embeddings(dev, scene, ex.rc)
    n = pe.shape[0] * pe.shape[1]
    mesh = parallel.make_mesh(TP_SHARDS, ("model",))

    _build.reset_launch_counts()
    with torch.no_grad():
        got = mlp_tp_fused.fused_nerf_mlp_tp(model, pe, ve, mesh)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
    check(got.shape == (*pe.shape[:2], 4) and counts["mlp_tp_pair_bf16"]
          == 5 * TP_SHARDS and sum(counts.values()) == 5 * TP_SHARDS,
          f"the bf16 TP forward's launches: {counts}")
    launches = {"mlp_tp_pair_bf16": counts["mlp_tp_pair_bf16"]}
    flat = lambda t: t.reshape(-1, t.shape[-1])
    with torch.no_grad():
        kb5 = mlp_fused.fused_nerf_mlp(model, pe, ve)
        dense16 = nerf.apply_mlp(model, flat(pe), flat(ve))
        dense32 = nerf.apply_mlp(model32, flat(pe), flat(ve))
    to_kb5 = held_to_bf16_distance("bf16 TP forward against K-B5 bf16",
                                   flat(got), flat(kb5), dense32)
    to_dense = held_to_bf16_distance(
        "bf16 TP forward against the dense plain bf16 MLP", flat(got),
        dense16, dense32)
    # each launch of K-B6 bf16 against its plain version on the forward's
    # tensors; the float32 pair of the float32 model's same shard on the same
    # x is the far end of the distance (the forward's bf16 shards are the
    # cached ones, found by their storage)
    devices = mesh.axis_devices("model")
    shards16, _r = mlp_fused.PACKS.get(
        model, ("tp_bf16", tuple(devices)),
        lambda m: mlp_tp_fused.place_tp_weights(m, devices, torch.bfloat16))
    shards32, _r = mlp_tp_fused.place_tp_weights(model32, devices)
    f32_of = {t16.data_ptr(): sh32[key]
              for (_d, sh16), (_d, sh32) in zip(shards16, shards32)
              for key, t16 in sh16.items() if t16.dtype == torch.bfloat16}
    seen = []
    real = mlp_tp_fused.fused_pair_bf16

    def both(x, wa, ba, wb, relu_mid=True):
        out = real(x, wa, ba, wb, relu_mid)
        seen.append((x.shape[0], held_to_bf16_distance(
            f"K-B6 bf16 launch {len(seen)} of the TP forward", out,
            mlp_tp_fused.fused_pair_bf16_plain(x, wa, ba, wb, relu_mid),
            mlp_tp_fused.fused_pair_plain(x, f32_of[wa.data_ptr()], ba,
                                          f32_of[wb.data_ptr()],
                                          relu_mid))))
        return out
    with swapped(mlp_tp_fused, "fused_pair_bf16", both), torch.no_grad():
        again = mlp_tp_fused.fused_nerf_mlp_tp(model, pe, ve, mesh)
    check(torch.equal(again, got), "two bf16 TP forwards differ")
    check(len(seen) == 5 * TP_SHARDS and {r[0] for r in seen} == {n},
          f"held {len(seen)} launches of {sorted({r[0] for r in seen})} points")
    share = lambda i: max(r[1][i] / r[1][i + 2] for r in seen)
    print(f"[19] bf16 TP slice, mesh {mesh.shape} of {dev}, {n} points: "
          f"against K-B5 bf16 {to_kb5[0] / to_kb5[2]:.3f} / "
          f"{to_kb5[1] / to_kb5[3]:.3f} of the bf16-to-float32 distance, "
          f"against the dense plain bf16 MLP {to_dense[0] / to_dense[2]:.3f} "
          f"/ {to_dense[1] / to_dense[3]:.3f}; {launches['mlp_tp_pair_bf16']} "
          f"K-B6 bf16 launches, 0 float32; each against its plain version on "
          f"the forward's tensors: at most {share(0):.3f} / {share(1):.3f} of "
          f"its distance")

    # one test view with the MLP called as fused_nerf_mlp on the renderer's
    # embeddings (phase 10's swap): K-B5 bf16 on the renderer's chunks
    pairs = [(mlp_fused.pack_weights_bf16(m16), mlp_fused.pack_weights(m32))
             for m16, m32 in ((model, model32), (fine, fine32))]
    seen5 = []
    real5 = mlp_fused.mlp_embedded_bf16

    def both5(buf, p, v):
        out = real5(buf, p, v)
        packed = next(f32 for b16, f32 in pairs if torch.equal(b16, buf))
        seen5.append((p.shape[0], held_to_bf16_distance(
            f"K-B5 bf16 launch {len(seen5)} of the view", out,
            mlp_fused.fused_nerf_mlp_bf16_plain(buf, p, v),
            mlp_fused.fused_nerf_mlp_plain(packed, p, v))))
        return out
    _build.reset_launch_counts()
    with swapped(renderer, "_query_mlp", _query_embedded):
        t0 = time.perf_counter()
        psnr = ex.test_model(sd)
        torch.cuda.synchronize()
        t_view = time.perf_counter() - t0
        counts = _build.launch_counts()
        with swapped(mlp_fused, "mlp_embedded_bf16", both5):
            ex._render_views(model, fine, scene["i_test"][:1])
    check(counts["mlp_embedded_bf16"] > 0
          and sum(counts.values()) == counts["mlp_embedded_bf16"],
          f"the bf16 embedded render's launches: {counts}")
    launches["mlp_embedded_bf16"] = counts["mlp_embedded_bf16"]
    rays, rc = scene["H"] * scene["W"], ex.rc
    sizes = {min(rc.chunk, rays - r0) * s
             for r0 in range(0, rays, rc.chunk)
             for s in (rc.n_samples, rc.n_samples + rc.n_importance)}
    check({r[0] for r in seen5} == sizes
          and len(seen5) == 2 * -(-rays // rc.chunk),
          f"K-B5 bf16: held launches of {sorted({r[0] for r in seen5})} "
          f"points, {len(seen5)} in all; the view has {sorted(sizes)}")
    share5 = lambda i: max(r[1][i] / r[1][i + 2] for r in seen5)
    print(f"[19] NDC {FERN_HW[0]}x{FERN_HW[1]}, 64+64, bf16 teacher through "
          f"K-B5 bf16: test PSNR {psnr:.4f} dB in {t_view:.2f} s, "
          f"{counts['mlp_embedded_bf16']} launches (through K-B3 bf16, phase "
          f"15: {psnr_kb3_bf16:.4f} dB, {psnr - psnr_kb3_bf16:+.4f}); "
          f"{len(seen5)} launches of one view, {min(sizes)} to {max(sizes)} "
          f"points, each against its plain version: at most {share5(0):.3f} "
          f"/ {share5(1):.3f} of its distance")
    check(np.isfinite(psnr) and abs(psnr - psnr_kb3_bf16) <= 0.1,
          f"K-B5 bf16 render {psnr} dB, K-B3 bf16 render {psnr_kb3_bf16} dB")

    # the port's tools/tp_mlp_bench.py in bf16 (its defaults)
    before = _build.launch_counts()
    bench = tp_mlp_bench.main([])
    after = _build.launch_counts()
    check(bench["dtype"] == "bfloat16" and set(bench["launches"])
          == {"mlp_embedded_bf16", "mlp_tp_pair_bf16"}
          and bench["launches"] == {k: after[k] - before[k] for k in after
                                    if after[k] != before[k]},
          f"tp_mlp_bench's launches: {bench['launches']}")
    for name, k in bench["launches"].items():
        launches[name] += k
    print(f"[19] tp_mlp_bench (bf16, {bench['n']} points): K-B5 bf16 "
          f"{bench['kb5_ms']:.3f} ms; one shard's forward "
          + ", ".join(f"M={m} {ms:.3f} ms (K-B5 / {m} = "
                      f"{bench['kb5_ms'] / m:.3f})"
                      for m, ms in bench["shard_ms"].items()))
    return launches


# phase 20: the occupancy-grid mode ------------------------------------------
# the reference's quality sweep (bench.py:145-212): 160x256 views at focal
# 0.8 W of 4 poses from look_at_poses(4, seed=1), grids at res 128 from the
# coarse network, 48 candidates, a budget of 16, blocks of 4 x 4 rays; its
# figures (VERDICT r5), device-independent: devPSNR 47.19 dB on the solid
# teacher, 33.23 dB on the fog teacher
OCC_SWEEP_HW = (160, 256)
OCC_RES, OCC_CANDIDATES, OCC_BUDGET, OCC_SUBSAMPLE = 128, 48, 16, 4
OCC_REF_DEVPSNR = {"solid": 47.19, "fog": 33.23}
# the fog teachers' generator seeds, (coarse, fine): the reference's are
# PRNGKey(7) / PRNGKey(8), which the port cannot draw; a random fog's
# devPSNR depends on the draw, so four pairs are swept
OCC_FOG_SEEDS = ((7, 8), (0, 1), (2, 3), (4, 5))
OCC_SOLID_MIN = 47.0
OCC_STEPS = 20
OCC_TYPES = {"float32": (torch.float32, "mlp_from_points",
                         "render_pass_packed", "mlp_train_fwd",
                         "mlp_train_bwd"),
             "bf16": (torch.bfloat16, "mlp_from_points_bf16",
                      "render_pass_bf16", "mlp_train_fwd_bf16",
                      "mlp_train_bwd_bf16")}


def _kb3_plain():
    """A block in which K-B3's wrappers (both types) run their plain
    versions on CUDA tensors."""
    stack = contextlib.ExitStack()
    for name, plain in (
            ("mlp_from_points", mlp_fused.fused_nerf_mlp_from_points_plain),
            ("mlp_from_points_bf16",
             mlp_fused.fused_nerf_mlp_from_points_bf16_plain)):
        stack.enter_context(swapped(
            mlp_fused, name, lambda packed, pts, dirs, _p=plain, **_kernel:
            _p(packed, pts, dirs)))
    return stack


def _kb2_plain():
    """A block in which K-B2's wrappers (both types) run their plain
    versions on CUDA tensors."""
    stack = contextlib.ExitStack()
    stack.enter_context(swapped(
        render_fused, "render_pass",
        lambda packed, *a, packed_mma=None, **kw:
        render_fused.fused_render_pass_plain(packed, *a, **kw)))
    stack.enter_context(swapped(render_fused, "render_pass_bf16",
                                render_fused.fused_render_pass_bf16_plain))
    stack.enter_context(swapped(
        render_fused, "render_pass_packed",
        lambda packed, *a, packed_mma=None, **kw:
        render_fused.fused_render_pass_packed_plain(packed, *a, **kw)))
    return stack


def _sweep_sigma(model, dev):
    """The grid's density sweep (occupancy.build_occupancy_grid at res
    OCC_RES over (-2, 2)^3): sigma (res^3,) through whatever K-B3's
    wrappers are, and the first chunk's (pts, dirs)."""
    axes = [-2.0 + (np.arange(OCC_RES, dtype=np.float32) + 0.5) * 4.0
            / OCC_RES] * 3
    pts = torch.as_tensor(np.stack(np.meshgrid(*axes, indexing="ij"),
                                   axis=-1).reshape(-1, 3), device=dev)
    vd = torch.zeros(N_POINTS, 3, device=dev)
    vd[:, 2] = 1.0
    chunks = torch.split(pts, N_POINTS)
    sigma = torch.cat([torch.relu(mlp_fused.fused_nerf_mlp_from_points(
        model, p, vd[:p.shape[0]])[:, 3]) for p in chunks])
    return sigma, (chunks[0].contiguous(), vd[:chunks[0].shape[0]])


def _recorded(module, name, calls):
    """Inside the block every call of <module>.<name> also appends its
    arguments to ``calls``."""
    real = getattr(module, name)

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)
    return swapped(module, name, record)


def _occ_views(hw, focal, poses):
    K = np.array([[focal, 0, hw[1] / 2], [0, focal, hw[0] / 2], [0, 0, 1]],
                 np.float32)
    return [get_rays_np(hw[0], hw[1], K, p[:3, :4]) for p in poses]


def _dev_psnr(model_c, model_f, rc, views):
    """The reference's devPSNR: min over the views of the fast render (the
    grid from the coarse network, the fine network along the selected
    samples) against the exact hierarchical render, both through the
    kernels. Returns (min devPSNR, max |d rgb|, open_boundary)."""
    grid = occupancy.build_occupancy_grid(model_c, res=OCC_RES)
    worst, dmax = math.inf, 0.0
    for ro, rd in views:
        exact = renderer.render_image(model_c, model_f, ro, rd, 2.0, 6.0,
                                      rc)["rgb_map"].cpu().numpy()
        fast = occupancy.render_image_fast(
            model_f, ro, rd, 2.0, 6.0, rc, grid, n_candidates=OCC_CANDIDATES,
            budget=OCC_BUDGET, subsample=OCC_SUBSAMPLE)["rgb_map"]
        mse = float(np.mean((fast - exact) ** 2))
        worst = min(worst, -10.0 * math.log10(max(mse, 1e-12)))
        dmax = max(dmax, float(np.abs(fast - exact).max()))
    return worst, dmax, grid.open_boundary


def _grid_against_plain(what, model, grid, dev, model32=None):
    """The grid through K-B3 against the grid through its plain version,
    before and after the dilation: a voxel may differ only at a threshold
    tie, where the two sigmas lie within the kernel's tolerance (TOL_RAW;
    in bf16 the sweep's largest bf16-to-float32 distance, ``model32`` the
    float32 model of the same weights). Returns (voxels apart before the
    dilation, after, the first sweep chunk's (pts, dirs))."""
    sig_k, chunk0 = _sweep_sigma(model, dev)
    with _kb3_plain():
        sig_p, _ = _sweep_sigma(model, dev)
        grid_p = occupancy.build_occupancy_grid(model)
        tol = TOL_RAW if model32 is None else float(
            (sig_p - _sweep_sigma(model32, dev)[0]).abs().max())
    thr = 1e-2
    d0 = ((sig_k > thr) != (sig_p > thr)).reshape((OCC_RES,) * 3)
    d3 = grid.occ != grid_p.occ
    ties = (sig_k - sig_p).abs().reshape(d0.shape)[d0]
    worst = float(ties.max()) if ties.numel() else 0.0
    check(worst <= tol, f"grid ({what}): {int(d0.sum())} voxels differ "
          f"before the dilation, |d sigma| up to {worst} against {tol}")
    check(not bool((d3 & ~occupancy._dilate(d0, 3)).any())
          and grid.open_boundary == grid_p.open_boundary,
          f"grid ({what}): voxels differ away from a threshold tie, or the "
          f"open boundary")
    return int(d0.sum()), int(d3.sum()), chunk0


def phase_occupancy(dev, scene, sd, tar, dec0):
    """Phase 20: the occupancy-grid mode on phase 4's scene and teacher and
    on the reference's quality sweep, in float32 and in bf16."""
    c = LEGO_HW / 2
    K = np.array([[LEGO_FOCAL, 0, c], [0, LEGO_FOCAL, c], [0, 0, 1]],
                 np.float32)
    pose = scene["poses"][scene["i_test"][0]]
    ro, rd = get_rays_np(LEGO_HW, LEGO_HW, K, pose[:3, :4])
    sweep = _occ_views(OCC_SWEEP_HW, 0.8 * OCC_SWEEP_HW[1],
                       synthetic.look_at_poses(4, seed=1))
    launches, shapes = {}, {}
    for tname, (dtype, kb3, kb2, kb1f, kb1b) in OCC_TYPES.items():
        cfg = nerf.NeRFConfig(compute_dtype=dtype)
        bf = dtype == torch.bfloat16
        peak = PEAK_BF16 if bf else PEAK_3XTF32
        ex = presets.create_nerf_model_executer(
            scene=scene, device=dev, use_fused_mlp=True, mlp_config=cfg,
            learning_rate=LSA_LR, verbose=False)
        ex.rc = dataclasses.replace(ex.rc, use_occupancy_renders=True,
                                    use_occupancy_tuning=True)
        model_c, model_f = ex._split_params(sd)
        # the solid teacher (no weight noise): phase 4's teacher carries
        # N(0, 1e-2) noise on every weight, whose density leaks through the
        # whole box (an open boundary), so the compacted frames are timed on
        # the solid one, the regime the grid is for
        solid = synthetic.make_solid_mlp(cfg, device=dev)
        f32 = lambda m: nerf.params_from_state_dict(
            nerf.params_to_state_dict(m, ""), "", nerf.NeRFConfig(),
            device=dev)

        # the main path, counted: compress_model with both flags (the LSA
        # steps on the occupancy loss, its i_save views through the grid),
        # the decode's test view and a 400x400 frame of each teacher
        lsa_dir = os.path.join(OUT, f"occupancy_{tname}")
        bs = os.path.join(lsa_dir, "bitstream", "lego_occ.nnc")
        os.makedirs(os.path.dirname(bs))
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        nnc_tpu_torch.compress_model(
            tar, bitstream_path=bs, qp=-20, lsa=True, ioq=False, scene=scene,
            use_fused_mlp=True, learning_rate=LSA_LR, N_iters=OCC_STEPS,
            epochs=1, i_save=OCC_STEPS, render_factor=4, mlp_config=cfg,
            occupancy_renders=True, occupancy_tuning=True, device=dev,
            verbose=False)
        torch.cuda.synchronize()
        t_compress = time.perf_counter() - t0
        dec = nnc_tpu_torch.decompress_model(bs, verbose=False)
        psnr_occ = ex.test_model(dec)
        frames, kb2_calls = {}, []
        for label, (m_c, m_f) in (("phase 4's teacher", (model_c, model_f)),
                                  ("solid", (solid, solid))):
            grid = occupancy.build_occupancy_grid(m_f)
            run = lambda m_f=m_f, grid=grid: occupancy.render_image_fast(
                m_f, ro, rd, 2.0, 6.0, ex.rc, grid)
            with _recorded(render_fused, kb2, kb2_calls):
                fast = run()
            t_fast = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run()
                t_fast.append(time.perf_counter() - t0)
            frames[label] = (m_c, m_f, grid, run, fast, t_fast)
        counts = _build.launch_counts()
        mine = {k: counts[k] for k in (kb3, kb2, kb1f, kb1b)}
        check(all(n > 0 for n in mine.values()) and not any(
            n for k, n in counts.items() if k not in mine),
            f"occupancy mode ({tname}) launched {counts}")
        for k, n in mine.items():
            launches[k] = launches.get(k, 0) + n

        _psnrs, loss_log = read_result_file(os.path.join(lsa_dir,
                                                         "result.txt"))
        moved = max(float(np.abs(dec[k] - dec0[k]).max()) for k in dec0)
        check(len(loss_log) == OCC_STEPS and np.isfinite(loss_log).all()
              and os.path.exists(os.path.join(
                  lsa_dir, f"testset_step{OCC_STEPS}", "003.png"))
              and np.isfinite(psnr_occ) and psnr_occ > 20.0 and moved > 0.0,
              f"occupancy LSA ({tname}): {len(loss_log)} losses logged, "
              f"test PSNR {psnr_occ} dB, decoded weights moved {moved}, or "
              f"its i_save view is missing")
        print(f"[20] occupancy mode, {tname}, lego {LEGO_HW}x{LEGO_HW}: "
              f"compress(lsa, {OCC_STEPS} steps on the occupancy loss, "
              f"i_save views through the grid) {t_compress:.1f} s, loss "
              f"{loss_log[0]:.3e} -> {loss_log[-1]:.3e}, decoded weights "
              f"moved up to {moved:.3e}; test view through the grid "
              f"{psnr_occ:.4f} dB; launches {mine}")

        # -- after the counts were read: timing of the exact frames, and
        # every kernel held against its plain version
        for label, (m_c, m_f, grid, run, fast, t_fast) in frames.items():
            t_exact = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                exact = renderer.render_image(m_c, m_f, ro, rd, 2.0, 6.0,
                                              ex.rc)
                torch.cuda.synchronize()
                t_exact.append(time.perf_counter() - t0)
            mse = float(np.mean((fast["rgb_map"]
                                 - exact["rgb_map"].cpu().numpy()) ** 2))
            n0, n3, chunk0 = _grid_against_plain(
                f"{tname}, {label}", m_f, grid, dev,
                f32(m_f) if bf else None)
            print(f"     {label}: a {LEGO_HW}x{LEGO_HW} frame through the "
                  f"grid {[f'{t:.4f}' for t in t_fast]} s, exact through the "
                  f"kernels {[f'{t:.4f}' for t in t_exact]} s, devPSNR "
                  f"{-10 * math.log10(max(mse, 1e-12)):.2f} dB; grid "
                  f"occupancy {float(grid.occ.float().mean()):.4f}, open "
                  f"boundary {grid.open_boundary}; through {kb3} against "
                  f"its plain version {n0} voxels apart before the "
                  f"dilation, {n3} after")

        # K-B3 at the sweep's shape: a chunk of 262,144 voxel centres
        p0, v0 = chunk0
        if bf:
            buf, w3 = mlp_fused.packed_bf16_for(solid), \
                mlp_fused.packed_wg_for(solid)
            run3 = lambda: mlp_fused.mlp_from_points_bf16(buf, p0, v0,
                                                          packed_wg=w3)
            plain3 = lambda: mlp_fused.fused_nerf_mlp_from_points_bf16_plain(
                buf, p0, v0)
        else:
            buf = mlp_fused.pack_weights(solid)
            w3 = mlp_fused.repack_mma(buf)
            run3 = lambda: mlp_fused.mlp_from_points(buf, p0, v0, w3)
            plain3 = lambda: mlp_fused.fused_nerf_mlp_from_points_plain(
                buf, p0, v0)
        raw3 = run3()
        shapes[f"{kb3}, grid sweep"] = {
            "points": p0.shape[0], "max_abs_err": maxabs(raw3, plain3()),
            "ms": cuda_ms(run3), "plain_ms": cuda_ms(plain3),
            **bound(nbytes(w3, p0, v0, raw3), 2 * MLP_MACS * p0.shape[0],
                    peak)}

        # the solid frame through K-B2 against the same selection through
        # its plain version (in bf16 also the float32 plain frame)
        _m_c, m_f, grid, run, fast, _t = frames["solid"]
        with _kb2_plain():
            fast_p = run()
            fast_32 = occupancy.render_image_fast(
                f32(m_f), ro, rd, 2.0, 6.0, dataclasses.replace(
                    ex.rc, mlp=nerf.NeRFConfig()), grid) if bf else None
        if bf:
            e = held_to_bf16_distance(
                "occupancy frame rgb (bf16)",
                *(torch.as_tensor(f["rgb_map"])
                  for f in (fast, fast_p, fast_32)))
            frame_err = f"rgb {e[0] / e[2]:.3f} / {e[1] / e[3]:.3f} " \
                f"(rms / max) of the bf16-to-float32 distance"
        else:
            eps = ex.rc.early_term_eps
            d = {k: maxabs(torch.as_tensor(fast[k]),
                           torch.as_tensor(fast_p[k]))
                 for k in ("rgb_map", "acc_map", "depth_map")}
            check(max(d["rgb_map"], d["acc_map"]) <= 2 * eps
                  and d["depth_map"] <= 2 * eps * 6.0,
                  f"occupancy frame against plain K-B2: {d}")
            frame_err = f"max|d| {d}"
        # K-B2 at the frame's shape: the solid frame's one launch's inputs;
        # in float32 the packed render pass, and render_pass_kernel on the
        # same launch beside it (the maps bit for bit)
        check(len(kb2_calls) == 2, f"two frames launched {kb2} "
              f"{len(kb2_calls)} times")
        args, kw = kb2_calls[1]
        args = args[:8]
        if bf:
            run2 = lambda: render_fused.render_pass_bf16(
                *args, want_weights=False)[0]
            plain2 = lambda: render_fused.fused_render_pass_bf16_plain(
                *args, want_weights=False)[0]
            runs2 = {kb2: run2}
        else:
            run2 = lambda: render_fused.render_pass_packed(
                *args, packed_mma=kw["packed_mma"])
            plain2 = lambda: render_fused.fused_render_pass_packed_plain(
                *args)
            runs2 = {kb2: run2, "render_pass": lambda: render_fused
                     .render_pass(*args, want_weights=False,
                                  packed_mma=kw["packed_mma"])[0]}
        maps2 = run2()
        needed = render_work.kb2_points(kb2, args)[0]
        R2, S2 = args[4].shape
        for name, fn in runs2.items():
            maps_n = fn()
            computed = render_work.kb2_points(name, args)[1]
            check(name == kb2 or torch.equal(maps_n, maps2),
                  f"the packed render pass parts from render_pass on the "
                  f"solid frame's launch: max|d| {maxabs(maps_n, maps2)}")
            shapes[f"{name}, compacted"] = {
                "rays": R2, "samples": S2, "points_needed": needed,
                "points_computed": computed,
                "max_abs_err": maxabs(maps_n, plain2()),
                "ms": cuda_ms(fn), "plain_ms": cuda_ms(plain2),
                **bound(nbytes(args[0] if kw.get("packed_mma") is None
                               else kw["packed_mma"], *args[1:7], maps_n),
                        2 * MLP_MACS * needed, peak)}
            print(f"     the solid frame through {name} against its plain "
                  f"version: {frame_err}; its launch: {R2} rays x {S2} "
                  f"samples, {needed} points needed, {computed} computed"
                  + ("" if name == kb2 else "; its maps the packed render "
                     "pass's bit for bit"))

        # the reference's quality sweep: devPSNR of the fast render against
        # the exact one through the kernels, on the solid and the fog
        # teacher
        rc_q = renderer.RenderConfig(
            mlp=cfg, n_samples=64, n_importance=128, white_bkgd=True,
            use_fused_mlp=True, use_fused_compositing=True)
        psnr_s, dmax_s, open_s = _dev_psnr(solid, solid, rc_q, sweep)
        fogs = {}
        for seeds in OCC_FOG_SEEDS:
            fog = [synthetic._activate(nerf.init_params(cfg, g), g).to(dev)
                   for g in (torch.Generator().manual_seed(s)
                             for s in seeds)]
            fogs[seeds] = _dev_psnr(*fog, rc_q, sweep)
        print(f"     quality sweep {OCC_SWEEP_HW[0]}x{OCC_SWEEP_HW[1]}, 4 "
              f"poses, res {OCC_RES}, {OCC_CANDIDATES} candidates, budget "
              f"{OCC_BUDGET}, subsample {OCC_SUBSAMPLE}: devPSNR solid "
              f"{psnr_s:.2f} dB (max |d| {dmax_s:.4f}; the reference "
              f"{OCC_REF_DEVPSNR['solid']}), open boundary {open_s}; fog "
              f"teachers (seeds: devPSNR dB, max |d|, open boundary; the "
              f"reference's fog teacher {OCC_REF_DEVPSNR['fog']}) "
              + ", ".join(f"{s}: {p:.2f}, {d:.4f}, {o}"
                          for s, (p, d, o) in fogs.items()))
        check(psnr_s >= OCC_SOLID_MIN and not open_s
              and all(o and np.isfinite(p) for p, _d, o in fogs.values()),
              f"quality sweep ({tname}): solid {psnr_s} dB (bar "
              f"{OCC_SOLID_MIN}), open boundary {open_s}; fog {fogs}")

        # K-B1 on the occupancy loss's points: one batch of 1,024 training
        # rays, 32 selected samples each on the tuning grid (dilate 1) of
        # phase 4's teacher, LSA scales std 0.05
        grid1 = occupancy.build_occupancy_grid(model_f, dilate=1)
        b_ro, b_rd, _tgt = ex._make_batcher().next_batch()
        b_ro, b_rd = (torch.as_tensor(a, device=dev) for a in (b_ro, b_rd))
        z = occupancy.select_occupied_samples(grid1, b_ro, b_rd, 2.0, 6.0,
                                              64, 32)[0]
        n1 = z.numel()
        pts1 = (b_ro[:, None, :] + b_rd[:, None, :] * z[..., None]) \
            .reshape(-1, 3)
        vd1 = (b_rd / torch.linalg.norm(b_rd, dim=-1, keepdim=True))[
            :, None, :].expand(*z.shape, 3).reshape(-1, 3).contiguous()
        cot = 1e-3 * torch.randn(n1, 4, device=dev, generator=torch
                                 .Generator(device=dev).manual_seed(20))
        tensors = mlp_train_fused._layer_tensors(nerf.init_lsa_scales(
            ex._split_params(sd)[1], std=0.05,
            generator=torch.Generator().manual_seed(21)))
        params, params_t, ls = mlp_train_fused.pack_train(
            tensors[0::3], tensors[1::3], tensors[2::3])
        biases = mlp_train_fused.gather_biases(params)
        packs = (mlp_train_fused.pack_train_bf16 if bf
                 else mlp_train_fused.pack_train_wgmma)(tensors[0::3])
        fwd = mlp_train_fused.mlp_train_fwd_bf16 if bf \
            else mlp_train_fused.mlp_train_fwd
        bwd = mlp_train_fused.mlp_train_bwd_bf16 if bf \
            else mlp_train_fused.mlp_train_bwd
        fwd_p = mlp_train_fused.mlp_train_fwd_bf16_plain if bf \
            else mlp_train_fused.mlp_train_fwd_plain
        bwd_p = mlp_train_fused.mlp_train_bwd_bf16_plain if bf \
            else mlp_train_fused.mlp_train_bwd_plain
        run_f = lambda: fwd(params, ls, pts1, vd1, True, packs[0], biases)
        raw1, ws1 = run_f()
        run_b = lambda: bwd(params, params_t, ls, pts1, vd1, cot, ws1,
                            False, packs[1], biases)
        flat1 = run_b()
        torch.cuda.synchronize()
        raw1_p = fwd_p(params, ls, pts1, vd1)
        flat1_p = bwd_p(params, params_t, ls, pts1, vd1, cot, False)
        if bf:
            e = held_to_bf16_distance(
                "K-B1 bf16 on the occupancy loss's points", raw1, raw1_p,
                mlp_train_fused.mlp_train_fwd_plain(params, ls, pts1, vd1))
            gerr = grads_to_bf16_distance(
                "K-B1 bf16 backward on the occupancy loss's points", flat1,
                flat1_p, mlp_train_fused.mlp_train_bwd_plain(
                    params, params_t, ls, pts1, vd1, cot, False), False)
            kb1_err = f"raw {e[0] / e[2]:.3f} / {e[1] / e[3]:.3f} of the " \
                f"distance, gradients {gerr}"
        else:
            err_raw = maxabs(raw1, raw1_p)
            err_g, _abs, ok = grad_errors(
                mlp_train_fused.split_grads(flat1, False),
                mlp_train_fused.split_grads(flat1_p, False))
            check(err_raw <= 1e-3 and ok, f"K-B1 on the occupancy loss's "
                  f"points: raw {err_raw}, gradients {err_g} of their max")
            kb1_err = f"max|draw| {err_raw:.3e}, gradients {err_g:.3e} of " \
                f"their max"
        f_ms, b_ms = cuda_ms(run_f), cuda_ms(run_b)
        shapes[f"{kb1f}, occupancy loss"] = {
            "points": n1, "max_abs_err": maxabs(raw1, raw1_p), "ms": f_ms,
            "plain_ms": cuda_ms(lambda: fwd_p(params, ls, pts1, vd1)),
            **bound(nbytes(packs[0], ls, biases, pts1, vd1, raw1, ws1),
                    2 * MLP_MACS * n1, peak)}
        shapes[f"{kb1b}, occupancy loss"] = {
            "points": n1, "max_abs_err": maxabs(flat1, flat1_p), "ms": b_ms,
            "plain_ms": cuda_ms(lambda: bwd_p(params, params_t, ls, pts1,
                                              vd1, cot, False)),
            **bound(nbytes(packs[1], ls, biases, cot, ws1, flat1),
                    2 * BWD_MACS * n1, peak)}
        del ws1
        # an LSA step on the occupancy loss beside the exact step, in turns
        ms_occ, ms_exact = [], []
        for _ in range(2):
            ms_occ.append(_lsa_run(ex, *ex._split_params(dec0), None,
                                   grid=grid1)[1])
            ms_exact.append(_lsa_run(ex, *ex._split_params(dec0), None)[1])
        shapes[f"LSA step, {tname}"] = {"occupancy_ms": min(ms_occ),
                                        "exact_ms": min(ms_exact)}
        print(f"     K-B1 on the occupancy loss's points ({b_ro.shape[0]} "
              f"rays x 32 = {n1}): {kb1_err}; fwd {f_ms:.3f} ms, bwd "
              f"{b_ms:.3f} ms; LSA step ({TRAJ_STEPS} steps, in turns) "
              f"occupancy {[f'{t:.2f}' for t in ms_occ]} ms, exact "
              f"{[f'{t:.2f}' for t in ms_exact]} ms")
    print("occupancy shapes: " + json.dumps(shapes))
    return launches

# phase 21: the multi-step LSA call -------------------------------------------
SCAN_K = 8            # tune_lsa_scales' default steps_per_call
SCAN_ITERS, SCAN_SAVE = 24, 10   # calls [1, 8, 1, 8, 1 x 6] at K = 8
SCAN_TIMED = 4 * SCAN_K          # the timed runs: four full calls


def phase_scan(dev, scene, sd, dec0, card):
    """Phase 21: the reference's multi-step LSA call on phase 7's scene, in
    float32 and bf16, on the exact loss and the occupancy loss: K = 8 steps
    a call (one replay of a CUDA graph each) against single steps."""
    rows = {}
    for tname, dtype in (("float32", torch.float32),
                         ("bf16", torch.bfloat16)):
        cfg = nerf.NeRFConfig(compute_dtype=dtype)
        kb1 = LSA_KERNELS if dtype == torch.float32 else LSA_BF16_KERNELS
        ex = presets.create_nerf_model_executer(
            scene=scene, device=dev, use_fused_mlp=True, mlp_config=cfg,
            learning_rate=LSA_LR, verbose=False)
        # phase 20's tuning grid: phase 4's fine network, dilated once
        grid = occupancy.build_occupancy_grid(ex._split_params(sd)[1],
                                              dilate=1)
        for loss, g in (("exact", None), ("occupancy", grid)):
            runs = {}
            for k in (SCAN_K, 1):
                stats = {}
                _build.reset_launch_counts()
                ls_c, ls_f, *_ = lsa.tune_lsa_scales(
                    *ex._split_params(dec0), ex._make_batcher(), ex.rc,
                    scene["near"], scene["far"], learning_rate=LSA_LR,
                    epochs=1, n_iters=SCAN_ITERS, i_save=SCAN_SAVE,
                    steps_per_call=k, grid=g, verbose=False, stats=stats)
                torch.cuda.synchronize()
                counts = _build.launch_counts()
                runs[k] = (torch.cat([torch.cat(list(d.values()))
                                      for d in (ls_c, ls_f)]), counts, stats)
            (ls8, n8, st8), (ls1, n1, _st1) = runs[SCAN_K], runs[1]
            calls = [c[0] for c in st8["calls"]]
            check(calls == [c for e in lsa.call_lengths(
                1, SCAN_ITERS, SCAN_K, SCAN_SAVE) for c in e]
                and calls.count(SCAN_K) == 2,
                f"phase 21 calls at K = {SCAN_K}: {calls}")
            # the two routes run the same kernels on the same inputs in the
            # same order, and none of the step's kernels sums with atomics:
            # the scales must agree bit for bit
            diff = float((ls8 - ls1).abs().max())
            check(torch.equal(ls8, ls1),
                  f"phase 21 ({tname}, {loss}): {SCAN_K} steps a call and "
                  f"single steps differ by {diff} in the scales")
            want8 = 2 * (SCAN_ITERS + st8["warmup_steps"])
            check(all(n8[k] == want8 and n1[k] == 2 * SCAN_ITERS
                      for k in kb1) and not any(
                          v for k, v in n8.items() if k not in kb1),
                  f"phase 21 ({tname}, {loss}) launches: K = {SCAN_K} "
                  f"{n8}, single steps {n1}")
            timed = {}
            for k in (SCAN_K, 1, 1, SCAN_K):
                m = lsa_profile.measure(
                    ex, lambda: ex._split_params(dec0), k, SCAN_TIMED, g)
                timed.setdefault(k, []).append(m)
            line = []
            for k, ms in timed.items():
                best = min(ms, key=lambda m: m["step_ms"])
                row = {"step_ms": [m["step_ms"] for m in ms],
                       "busy_ms": best["busy_ms"], "idle": best["idle"],
                       "launches": {n: n8[n] if k == SCAN_K else n1[n]
                                    for n in kb1},
                       "capture_s": st8["capture_s"] if k == SCAN_K else 0.0,
                       "pool_mb": st8["pool_bytes"] / 2 ** 20
                       if k == SCAN_K else 0.0}
                rows[f"{tname}, {loss}, K={k}"] = row
                steps = ", ".join(f"{t:.3f}" for t in row["step_ms"])
                line.append(
                    f"K={k}: step {steps} ms, device busy "
                    f"{row['busy_ms']:.3f} ms, idle "
                    f"{100 * row['idle']:.1f}%, K-B1 launches "
                    f"{row['launches']}, capture {row['capture_s']:.3f} s, "
                    f"graph pool {row['pool_mb']:.0f} MB")
            print(f"[21] {tname}, {loss} loss, {SCAN_ITERS} steps "
                  f"(i_save {SCAN_SAVE}), scales bit-equal across routes; "
                  f"{SCAN_TIMED}-step runs in turns on {card}: "
                  + "; ".join(line))
    print("multi-step LSA: " + json.dumps(rows))
    return rows

NERF_PYT_STEPS = 16   # two full calls of steps_per_call 8
CLS_DIMS = (3072, 1024, 1024, 10)
CLS_N = 4096
CONV_N = 2048
CLS_BATCH = 256
# a stated tolerance of a card run against the same run on the CPU: the
# max and the L2 norm of the difference, each within 1e-2 of how far the
# CPU run moved the tensors from where they started (phase 7's rule: a
# wrong gradient term moves a tensor by O(1) of that, float32 reassociation
# by ~1e-6 of it)
MOTION_TOL = 1e-2


def _against_cpu(what, got, want, start):
    """got / want / start: flat float64 numpy vectors. Returns the printed
    comparison; fails beyond MOTION_TOL of the motion."""
    d, m = got - want, want - start
    dmax, mmax = float(np.abs(d).max()), float(np.abs(m).max())
    dl2 = float(np.linalg.norm(d) / np.linalg.norm(m))
    check(mmax > 0 and dmax <= MOTION_TOL * mmax and dl2 <= MOTION_TOL,
          f"{what}: the card's run differs from the CPU's by max {dmax} "
          f"(bound {MOTION_TOL} x {mmax}), L2 {dl2} (bound {MOTION_TOL})")
    return (f"max |card - cpu| {dmax:.3e} of max motion {mmax:.3e}, L2 "
            f"{dl2:.3e} of the motion")


def _flat(*dicts):
    return np.concatenate([np.asarray(d[k], np.float64).ravel()
                           for d in dicts for k in sorted(d)])


def _nerf_pyt_phase(dev, scene, dec0, card):
    """(a) + (d): the NERF_PYT handler's epoch under trace_if against the
    direct tune_lsa_scales call with the reference's arguments."""
    rc = presets.make_render_config(scene, use_fused_mlp=True)
    trace_dir = os.path.join(OUT, "trace_nerf_pyt")
    sd = dict(dec0)
    kw = dict(learning_rate=LSA_LR, n_rand=1024)
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    with profiling.trace_if(trace_dir):
        with profiling.span("nerf_pyt_train"):
            psnr, loss = use_cases.use_cases["NERF_PYT"]().train(
                nerf_wrapper=sd, scene=scene, rc=rc, N_iters=NERF_PYT_STEPS,
                device=dev, **kw)
    torch.cuda.synchronize()
    t_handler = time.perf_counter() - t0
    launches = {k: _build.launch_counts()[k] for k in LSA_KERNELS}
    check(not any(v for k, v in _build.launch_counts().items()
                  if k not in LSA_KERNELS),
          f"the NERF_PYT epoch launched other kernels: "
          f"{_build.launch_counts()}")

    models = [nerf.params_from_state_dict(dec0, p, rc.mlp, device=dev)
              for p in ("model.", "model_fine.")]
    batcher = RayBatcher(scene["images"], scene["poses"], scene["K"],
                         scene["i_train"], kw["n_rand"],
                         mode=scene.get("batching_mode", "image"), seed=451)
    stats = {}
    ls_c, ls_f, *_ = lsa.tune_lsa_scales(
        *models, batcher, rc, scene["near"], scene["far"],
        learning_rate=LSA_LR, learning_rate_decay=0, epochs=1,
        n_iters=NERF_PYT_STEPS, i_save=0, seed=451, verbose=False,
        stats=stats)
    torch.cuda.synchronize()
    moved = 0.0
    for prefix, scales in (("model.", ls_c), ("model_fine.", ls_f)):
        for name, v in scales.items():
            got = sd[prefix + name + ".weight_scaling"]
            check(np.array_equal(got, v.cpu().numpy().reshape(-1, 1)),
                  f"NERF_PYT's {prefix}{name} scales differ from the "
                  f"direct tune_lsa_scales call's")
            moved = max(moved, float(np.abs(got - 1.0).max()))
    check(moved > 0.0, "the NERF_PYT epoch did not move the scales")
    # lsa's accounting: two K-B1 launches a step (coarse, fine), and the
    # graph's warm-up step before its capture
    want = 2 * (NERF_PYT_STEPS + stats["warmup_steps"])
    check(all(launches[k] == want for k in LSA_KERNELS),
          f"NERF_PYT's K-B1 launches {launches}, want {want} each")
    trace_path = os.path.join(trace_dir, profiling.TRACE_FILE)
    with open(trace_path) as f:
        trace = f.read()
    check("nerf_pyt_train" in trace and "nnc.lsa.call" in trace
          and "mlp_train_fwd_kernel" in trace and "mlp_train_bwd" in trace,
          "the trace lacks the region, the LSA calls' spans or K-B1's "
          "kernels")
    print(f"[22a] NERF_PYT().train at lego geometry, full width, N_rand "
          f"1024, {NERF_PYT_STEPS} steps on {card}: {t_handler:.2f} s under "
          f"trace_if, mean PSNR {psnr:.4f} dB, loss {loss:.4e}; scales "
          f"bit-equal to the direct tune_lsa_scales call, moved up to "
          f"{moved:.3e}; K-B1 launches {launches} (2 x ({NERF_PYT_STEPS} "
          f"+ {stats['warmup_steps']} warm-up))")
    print(f"[22d] trace_if wrote {os.path.getsize(trace_path)} bytes "
          f"holding the 'nerf_pyt_train' region, the nnc.lsa spans and "
          f"mlp_train_fwd_kernel / mlp_train_bwd kernels")
    return launches


def _classifier_phase(dev, card):
    """(b): ClassificationExecuter at 3072-1024-1024-10 through
    compress(lsa, ioq) on the card, and its LSA epochs against the CPU."""
    rng = np.random.default_rng(22)
    x = rng.standard_normal((CLS_N, CLS_DIMS[0])).astype(np.float32)
    teacher = rng.standard_normal((CLS_DIMS[0], CLS_DIMS[-1]))
    y = np.argmax(x @ teacher, axis=1)
    # random ReLU features, the head fitted to the teacher's logits: a
    # float model with an accuracy for IOQ to keep
    d, h = {}, x.astype(np.float64)
    for i, (din, dout) in enumerate(zip(CLS_DIMS[:-2], CLS_DIMS[1:-1])):
        w = rng.standard_normal((dout, din)) / np.sqrt(din)
        d[f"fc{i + 1}.weight"], d[f"fc{i + 1}.bias"] = w, np.zeros(dout)
        h = np.maximum(h @ w.T, 0.0)
    d["fc3.weight"] = np.linalg.lstsq(h, x @ teacher, rcond=None)[0].T
    d["fc3.bias"] = np.zeros(CLS_DIMS[-1])
    d = {k: v.astype(np.float32) for k, v in d.items()}

    def loader():
        for i in range(0, CLS_N, CLS_BATCH):
            yield x[i:i + CLS_BATCH], y[i:i + CLS_BATCH]

    layers = ["fc1", "fc2", "fc3"]
    ex = classification.ClassificationExecuter(
        classification.mlp_classifier_builder(layers, device=dev), loader,
        verbose=False)
    top1_float = ex.eval_model(d)[0]
    bs = os.path.join(OUT, "classifier_ioq.nnc")
    t0 = time.perf_counter()
    nnc_tpu_torch.compress_model(d, bitstream_path=bs, qp=-38, lsa=True,
                                 ioq=True, model_executer=ex,
                                 task_type="Classification", verbose=False)
    torch.cuda.synchronize()
    t_compress = time.perf_counter() - t0
    rec = nnc_tpu_torch.decompress(bs, verbose=False)
    top1_dec = ex.eval_model(rec)[0]
    check(top1_dec >= top1_float - 0.05,
          f"classifier IOQ top1 {top1_dec} against float {top1_float}")

    runs = []
    for device in (dev, "cpu"):
        cex = classification.ClassificationExecuter(
            classification.mlp_classifier_builder(layers, device=device),
            loader, verbose=False)
        runs.append(cex.tune_model(parameters=d, lsa_flag=True)[0])
    cmp = _against_cpu("classifier LSA scales", _flat(runs[0]),
                       _flat(runs[1]), 1.0)
    print(f"[22b] ClassificationExecuter {'-'.join(map(str, CLS_DIMS))}, "
          f"{CLS_N} samples in batches of {CLS_BATCH}, 2 epochs on {card}: "
          f"compress(lsa, ioq, qp=-38) {t_compress:.2f} s, "
          f"{os.path.getsize(bs)} bytes; top1 float {top1_float:.4f}, "
          f"decoded {top1_dec:.4f} (bar: no lower than 0.05 under); LSA "
          f"scales against the CPU run: {cmp}")


def _conv_phase(dev, card):
    """(c): TorchModuleExecuter on a conv net, LSA + FT through
    compress_model on the card, and its tuning against the CPU with cuDNN's
    TF32 off (the TF32-on difference printed beside it)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(22)
        net = torch.nn.Sequential(
            torch.nn.Conv2d(3, 64, 3, padding=1), torch.nn.ReLU(),
            torch.nn.Conv2d(64, 128, 3, stride=2, padding=1),
            torch.nn.ReLU(),
            torch.nn.Conv2d(128, 256, 3, stride=2, padding=1,
                            padding_mode="reflect"), torch.nn.ReLU(),
            torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten(),
            torch.nn.Linear(256, 10))
    sd = {k: v.numpy().copy() for k, v in net.state_dict().items()}
    rng = np.random.default_rng(23)
    x = rng.standard_normal((CONV_N, 3, 32, 32)).astype(np.float32)
    y = np.argmax(x.reshape(CONV_N, -1) @ rng.standard_normal((3072, 10)),
                  axis=1)

    def loader():
        for i in range(0, CONV_N, CLS_BATCH):
            yield x[i:i + CLS_BATCH], y[i:i + CLS_BATCH]

    kw = dict(learning_rate=1e-3, verbose=False)
    # the executer's own float32 convolutions (its default: TF32 off)
    ex = torch_executer.TorchModuleExecuter(net, loader, device=dev, **kw)
    bs = os.path.join(OUT, "conv_lsa_ft.nnc")
    t0 = time.perf_counter()
    nnc_tpu_torch.compress_model(sd, bitstream_path=bs, qp=-38, lsa=True,
                                 fine_tune=True, model_executer=ex,
                                 task_type="Classification", verbose=False)
    torch.cuda.synchronize()
    t_compress = time.perf_counter() - t0
    rec = nnc_tpu_torch.decompress(bs, verbose=False)
    check(set(rec) == set(sd) and all(np.isfinite(v).all()
                                      for v in rec.values()),
          "the conv net's bitstream does not decode to its tensors")
    acc = (ex.eval_model(sd)[0], ex.eval_model(rec)[0])

    # the comparison: two batches of one epoch, LSA and FT together
    cmp_kw = dict(kw, epochs=1, max_batches=2)
    start = _flat({k: np.ones(v.shape[0]) for k, v in sd.items()
                   if k.endswith(".weight")},
                  {k: v for k, v in sd.items() if k.endswith(".bias")})
    threads = torch.get_num_threads()
    ex_cpu = torch_executer.TorchModuleExecuter(net, loader, device="cpu",
                                                **cmp_kw)
    want = _flat(*ex_cpu.tune_model(parameters=sd, lsa_flag=True,
                                    ft_flag=True))
    torch.set_num_threads(threads)   # the CPU executer tunes on one thread
    got = {}
    for tf32 in (False, True):
        ex_card = torch_executer.TorchModuleExecuter(
            net, loader, device=dev, allow_tf32=tf32, **cmp_kw)
        got[tf32] = _flat(*ex_card.tune_model(parameters=sd, lsa_flag=True,
                                              ft_flag=True))
    cmp = _against_cpu("conv net LSA + FT", got[False], want, start)
    d_tf32 = float(np.abs(got[True] - want).max())
    print(f"[22c] TorchModuleExecuter on a conv net (3x32x32 -> 64 -> 128 "
          f"/2 -> 256 /2 reflect -> pool -> 10), {CONV_N} samples on "
          f"{card}: compress(lsa, fine_tune, qp=-38) {t_compress:.2f} s, "
          f"{os.path.getsize(bs)} bytes, decodes; top1 float {acc[0]:.4f}, "
          f"decoded {acc[1]:.4f}; scales + biases after 2 steps against "
          f"the CPU (the executer's float32 convolutions): {cmp}; built "
          f"with allow_tf32: max {d_tf32:.3e}")


def _kb2_recorded(records):
    """Inside the block the first K-B2 render pass of each (compute type,
    samples, weights, packed) that the renderer or the occupancy mode makes
    on the card is recorded: its model's tensors and config, its inputs and
    the maps the kernel gave, for :func:`_kb2_against_plain` after the
    path's counts were read."""
    copy = lambda v: v.clone() if torch.is_tensor(v) else v

    def recorder(real, packed):
        def record(model, *args, **kw):
            out = real(model, *args, **kw)
            key = (str(model.config.compute_dtype).split(".")[-1],
                   args[3].shape[1], kw.get("return_weights", not packed),
                   packed)
            if key not in records and args[3].is_cuda:
                records[key] = (
                    nerf.params_to_state_dict(model, ""), model.config,
                    [copy(a) for a in args],
                    {k: copy(v) for k, v in kw.items()},
                    {"maps": out.clone()} if packed
                    else {k: copy(v) for k, v in out.items()})
            return out
        return record
    stack = contextlib.ExitStack()
    record = recorder(render_fused.fused_render_pass, False)
    stack.enter_context(swapped(render_fused, "fused_render_pass", record))
    stack.enter_context(swapped(renderer, "fused_render_pass", record))
    stack.enter_context(swapped(
        render_fused, "fused_render_pass_packed",
        recorder(render_fused.fused_render_pass_packed, True)))
    return stack


def _rgb_acc_depth(out):
    m = out.get("maps")
    if m is not None:
        return m[:, :3], m[:, 3], m[:, 4]
    return out["rgb_map"], out["acc_map"], out["depth_map"]


def _bf16_held(what, got, plain16, plain32):
    """:func:`held_to_bf16_distance`, whose limit where the plain bf16 and
    float32 versions agree bit for bit (a teacher whose colour is a constant
    and whose rays are opaque or empty) is the kernel equal to them. Returns
    the errors as text."""
    if torch.equal(plain16, plain32):
        check(torch.equal(got, plain16), f"{what}: the plain bf16 and float32 "
              f"versions agree bit for bit and the kernel parts from them")
        return "equal to the plain bf16 version, itself equal to float32"
    e = held_to_bf16_distance(what, got, plain16, plain32)
    return (f"{e[0] / e[2]:.3f} / {e[1] / e[3]:.3f} (rms / max) of the "
            f"bf16-to-float32 distance")


def _kb2_against_plain(records, dev):
    """Each recorded K-B2 launch against its plain version on the same
    inputs: float32 at phase 3's bars (with early termination 2 eps for
    rgb / acc / weights and 2 eps x 6 for depth), bf16 held to the
    bf16-to-float32 distance as phase 20 holds its frames; a launch of the
    packed render pass also against render_pass_kernel's maps on the same
    rows, bit for bit."""
    shown = []
    for (tname, S, want_w, packed), (sd, cfg, args, kw, got) in sorted(
            records.items()):
        model = nerf.params_from_state_dict(sd, "", cfg, device=dev)
        if packed:
            ro, rd, vd, z, dists = args
            same = render_fused.fused_render_pass(
                model, ro, rd, vd, z, dists=dists,
                early_term_eps=kw.get("early_term_eps", 0.0),
                ray_flags=kw.get("ray_flags"), r_t=render_fused.RAY_TILE,
                return_weights=False, raw_maps=True)["maps"]
            check(torch.equal(got["maps"], same), f"K-B2's packed pass S={S} "
                  f"at a tool's shape parts from render_pass: max|d| "
                  f"{maxabs(got['maps'], same)}")
            with _kb2_plain():
                plain = {"maps": render_fused.fused_render_pass_packed(
                    model, *args, **kw)}
        else:
            with _kb2_plain():
                plain = render_fused.fused_render_pass(model, *args, **kw)
        R = args[3].shape[0]
        (rgb, acc, depth), (rgb_p, acc_p, depth_p) = (
            _rgb_acc_depth(o) for o in (got, plain))
        check(all(torch.isfinite(t).all().item() for t in (rgb, acc, depth)),
              f"K-B2 {tname} S={S} at a tool's shape: maps not finite")
        if tname == "bfloat16":
            model32 = nerf.params_from_state_dict(sd, "", nerf.NeRFConfig(),
                                                  device=dev)
            kw32 = dict(kw, r_t=math.lcm(kw.get("r_t", 64),
                                         render_fused.RAY_TILE))
            with _kb2_plain():
                rgb_32 = _rgb_acc_depth(render_fused.fused_render_pass(
                    model32, *args, **kw32))[0]
            shown.append(f"bf16 {R} rays S={S}: rgb " + _bf16_held(
                f"K-B2 bf16 S={S} at a tool's shape", rgb, rgb_p, rgb_32))
            continue
        eps = kw.get("early_term_eps", 0.0)
        tol, tol_depth = (1e-5, 1e-4) if eps == 0 else (2 * eps,
                                                         2 * eps * 6.0)
        d = {"rgb/acc": max(maxabs(rgb, rgb_p), maxabs(acc, acc_p)),
             "depth": maxabs(depth, depth_p)}
        if want_w:
            d["weights"] = maxabs(got["weights"], plain["weights"])
        check(d["rgb/acc"] <= tol and d["depth"] <= tol_depth
              and d.get("weights", 0.0) <= (1e-4 if eps == 0 else tol),
              f"K-B2 float32 S={S} at a tool's shape, eps {eps}: {d}")
        shown.append(f"float32 {R} rays S={S} weights={want_w} eps={eps}"
                     + (" packed, render_pass's maps bit for bit" if packed
                        else "") + ": "
                     + ", ".join(f"{k} {v:.3e}" for k, v in d.items()))
    return shown


def _tools_phase(dev, card):
    """(e): the port's tools on the card, each run as its command line; the
    first K-B2 launch of each shape they make is held against its plain
    version after the run."""
    launches, kb2 = {}, {}

    def counted(fn, argv, kernels):
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        with _kb2_recorded(kb2):
            out = fn(argv)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        for k in kernels:
            check(counts[k] > 0, f"{fn.__module__} launched no {k}")
            launches[k] = launches.get(k, 0) + counts[k]
        return out, time.perf_counter() - t0, {k: counts[k] for k in kernels}

    demo, t, n = counted(
        demo_synthetic.main, ["--full-mlp", "--iters", "100", "--out",
                              os.path.join(OUT, "demo")],
        LSA_KERNELS + ("render_pass",))
    print(f"[22e] demo_synthetic --full-mlp --iters 100 on {card}: "
          f"{t:.1f} s, launches {n}: " + json.dumps(demo))
    check(np.isfinite([demo["psnr_quantized"], demo["psnr_quantized_lsa"]])
          .all() and demo["psnr_quantized_lsa"] > demo["psnr_quantized"],
          f"LSA gained no PSNR in demo_synthetic: {demo}")
    recs, t, _n = counted(rd_sweep.main, [
        "--synthetic", "--qps", "-20", "-38", "--lsa-iters", "100", "--out",
        os.path.join(OUT, "rd")], ())
    by_qp = {(r["qp"], r["lsa"]): r["psnr"] for r in recs}
    check(len(recs) == 4 and np.isfinite(list(by_qp.values())).all()
          and all(by_qp[qp, True] >= by_qp[qp, False] for qp in (-20, -38)),
          f"rd_sweep records (finite PSNR, LSA losing none): {recs}")
    print(f"    rd_sweep --synthetic --qps -20 -38 --lsa-iters 100: {t:.1f} "
          f"s, (qp, lsa, bytes, psnr) " + json.dumps(
              [(r["qp"], r["lsa"], r["bytes"], r["psnr"]) for r in recs]))
    video_dir = os.path.join(OUT, "video")
    path, t, n = counted(render_video.main, [
        "--synthetic", "--frames", "4", "--out", video_dir],
        ("mlp_from_points_bf16", "render_pass_bf16"))
    check(len([f for f in os.listdir(video_dir)
               if f.startswith("frame_")]) == 4, "render_video's frames")
    print(f"    render_video --synthetic --frames 4 (grid route, 128x128, "
          f"bf16): {t:.1f} s with the grid, launches {n}, video {path}")
    psnrs, t, _n = counted(multi_scene_tool.main, [
        "--synthetic", "--n-scenes", "2", "--iters", "8"], ())
    check(len(psnrs) == 2 and np.isfinite(psnrs).all(),
          f"multi_scene PSNRs {psnrs}")
    print(f"    multi_scene --synthetic --n-scenes 2 --iters 8: {t:.1f} s, "
          f"last-step PSNR {psnrs}")
    rate = profile_codec.main(["--qp", "-20"])
    print(f"    profile_codec --qp -20 on this machine's host: encode "
          f"{rate['encode_mb_s']:.1f} MB/s, decode {rate['decode_mb_s']:.1f} "
          f"MB/s ({rate['raw_bytes']} -> {rate['bitstream_bytes']} bytes)")
    # demo_synthetic's test views (coarse S=64 with weights, fine S=96) in
    # float32, render_video's compacted frames in bf16
    check({k[0] for k in kb2} == {"float32", "bfloat16"},
          f"the tools' K-B2 launches recorded: {sorted(kb2)}")
    print("    K-B2 at the tools' shapes against its plain version: "
          + "; ".join(_kb2_against_plain(kb2, dev)))
    return launches


def phase_tools(dev, scene, dec0, card):
    """Phase 22: the classification side and the JAX-free tools."""
    launches = _nerf_pyt_phase(dev, scene, dec0, card)
    _classifier_phase(dev, card)
    _conv_phase(dev, card)
    for name, n in _tools_phase(dev, card).items():
        launches[name] = launches.get(name, 0) + n
    return launches


# phase 23: the render-side tools --------------------------------------------
# the tools' own kernels, by compute type: K-B3 (the fused_mlp route, the
# grids) and K-B2
RENDER_TOOL_KERNELS = {"float32": ("mlp_from_points", "render_pass",
                                   "render_pass_packed"),
                       "bfloat16": ("mlp_from_points_bf16",
                                    "render_pass_bf16")}
RENDER_TOOL_ITERS = 3


def _kb3_recorded(records, dense=False):
    """Inside the block the first K-B3 launch of each (compute type,
    points) that ``fused_nerf_mlp_from_points`` makes on the card is
    recorded (with ``dense``, the first whose raw holds a positive density:
    a grid's chunk that meets the solid, not empty space, whose raw does
    not depend on the layers that carry the density): its model's tensors
    and config, its inputs and the raw the kernel gave, for
    :func:`_kb3_against_plain` after the path's counts were read."""
    real = mlp_fused.fused_nerf_mlp_from_points

    def record(model, pts, viewdirs):
        out = real(model, pts, viewdirs)
        n = pts.numel() // 3
        key = (str(model.config.compute_dtype).split(".")[-1], n)
        if key not in records and pts.is_cuda \
                and mlp_fused.supports(model.config) \
                and (not dense or bool((out[..., 3] > 0).any())):
            records[key] = (
                nerf.params_to_state_dict(model, ""), model.config,
                pts.reshape(-1, 3).float().clone(),
                torch.broadcast_to(viewdirs, pts.shape).reshape(-1, 3)
                .float().clone(), out.reshape(-1, 4).clone())
        return out
    return swapped(mlp_fused, "fused_nerf_mlp_from_points", record)


def _kb3_against_plain(records, dev):
    """Each recorded K-B3 launch against its plain version on the same
    inputs: float32 at phase 2's bar (TOL_RAW at raw values up to 2.7) grown
    with the largest |raw| where that exceeds 2.7 (3xTF32's error is
    relative to its operands; the solid teacher's density reaches 150), bf16
    held to the bf16-to-float32 distance as phase 14 holds it."""
    shown = []
    for (tname, n), (sd, cfg, pts, vd, got) in sorted(records.items()):
        model32 = nerf.params_from_state_dict(sd, "", nerf.NeRFConfig(),
                                              device=dev)
        plain32 = mlp_fused.fused_nerf_mlp_from_points_plain(
            mlp_fused.pack_weights(model32), pts, vd)
        if tname == "bfloat16":
            model = nerf.params_from_state_dict(sd, "", cfg, device=dev)
            shown.append(f"bf16 {n} points: raw " + _bf16_held(
                f"K-B3 bf16 {n} points at a tool's shape", got,
                mlp_fused.fused_nerf_mlp_from_points_bf16_plain(
                    mlp_fused.pack_weights_bf16(model), pts, vd), plain32))
            continue
        err, top = maxabs(got, plain32), float(plain32.abs().max())
        tol = TOL_RAW * max(1.0, top / 2.7)
        check(torch.isfinite(got).all().item() and err <= tol,
              f"K-B3 float32 {n} points at a tool's shape: max |draw| {err} "
              f"> {tol} (values up to {top})")
        shown.append(f"float32 {n} points: max|draw| {err:.3e} at values up "
                     f"to {top:.1f} (bar {tol:.2e})")
    return shown


def _phase20_frame_stages(dev, scene, tname):
    """profile_fast_frame's stages on the 400x400 frame that phase 20 times:
    lego geometry, phase 4's first test pose, the solid teacher through its
    own grid."""
    cfg = nerf.NeRFConfig(compute_dtype=render_work.DTYPES[tname])
    solid = synthetic.make_solid_mlp(cfg, device=dev)
    grid = occupancy.build_occupancy_grid(solid)
    c = LEGO_HW / 2
    K = np.array([[LEGO_FOCAL, 0, c], [0, LEGO_FOCAL, c], [0, 0, 1]],
                 np.float32)
    pose = scene["poses"][scene["i_test"][0]]
    ro, rd = (torch.as_tensor(a.reshape(-1, 3), device=dev)
              for a in get_rays_np(LEGO_HW, LEGO_HW, K, pose[:3, :4]))
    t = profile_fast_frame.profile(solid, grid, ro, rd, (LEGO_HW, LEGO_HW),
                                   iters=RENDER_TOOL_ITERS)
    busy = "" if t["busy"] is None else \
        f", the device busy {t['busy']:.2f} ms"
    print(f"     phase 20's solid frame ({LEGO_HW}x{LEGO_HW}, lego focal): "
          f"select {t['select']:.2f} ms, + sort and gather #1 "
          f"{t['presort']:.2f}, render_rays_fast {t['full']:.2f} (K-B2 "
          f"{t['kb2']:.2f} of device time{busy}), render_image_fast "
          f"{t['frame']:.2f} ms")
    return t


def phase_render_tools(dev, card, scene):
    """Phase 23: the render-side tools on the card, in float32 and bf16, as
    their command lines at the reference's sizes with few iterations, and
    profile_fast_frame's stages on phase 20's frame; each run's first K-B2
    and K-B3 launch of each shape held against the plain versions after
    it."""
    launches, summary = {}, {}
    for tname, kernels in RENDER_TOOL_KERNELS.items():
        iters = ["--iters", str(RENDER_TOOL_ITERS), "--dtype", tname]
        runs = (
            ("bench_render_v2", lambda: bench_render_v2.main(
                ["--check"] + iters)),
            ("tune_fast_mode", lambda: tune_fast_mode.main(
                ["--floor"] + iters)),
            ("profile_fast_frame", lambda: profile_fast_frame.main(iters)),
            ("phase 20's frame", lambda: _phase20_frame_stages(dev, scene,
                                                               tname)))
        for label, run in runs:
            kb2, kb3 = {}, {}
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            with _kb2_recorded(kb2), _kb3_recorded(kb3):
                res = run()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = _build.launch_counts()
            mine = {k: counts[k] for k in kernels if counts[k]}
            # K-B3 and a K-B2 of its type (float32: the exact render's, or
            # the packed pass of compacted frames), and no other kernel
            check(kernels[0] in mine and len(mine) > 1 and not any(
                n for k, n in counts.items() if k not in mine),
                f"{label} ({tname}) launched {counts}")
            for k, n in mine.items():
                launches[k] = launches.get(k, 0) + n
            held = _kb2_against_plain(kb2, dev) + _kb3_against_plain(kb3, dev)
            print(f"[23] {label}, {tname}, on {card}: {seconds:.1f} s, "
                  f"launches {mine}; against the plain versions: "
                  + "; ".join(held))
            summary[f"{label} {tname}"] = res
        # the quality of the points, as phase 20's sweep holds it (47 dB at
        # 48 / 16 / 4 there); every number the tools print finite
        psnrs = [p["dev_psnr"]
                 for p in summary[f"tune_fast_mode {tname}"]["points"]]
        check(min(psnrs) > 40.0, f"tune_fast_mode ({tname}) devPSNR {psnrs}")
    check(np.isfinite(list(_numbers(summary))).all(),
          "a render tool printed a number that is not finite")
    print("render tools: " + json.dumps(summary))
    return launches


# phase 24: the bench ---------------------------------------------------------
BENCH_ARGV = ("--iters", "5", "--train-iters", "16")
# the bench's own kernels, by compute type: K-B3 (the grids), K-B2 (every
# render), K-B1 (the LSA steps)
BENCH_KERNELS = {
    "float32": ("mlp_from_points", "render_pass", "render_pass_packed",
                "mlp_train_fwd", "mlp_train_bwd"),
    "bfloat16": ("mlp_from_points_bf16", "render_pass_bf16",
                 "mlp_train_fwd_bf16", "mlp_train_bwd_bf16")}
BENCH_REF_TURBO = 46.53   # the reference's turbo devPSNR (BENCH_r05.json)
BENCH_TURBO_MIN = 40.0


def _kb1_recorded(records):
    """Inside the block the first K-B1 forward and backward launch of each
    (type, points) on the card outside a graph's capture is recorded: its
    inputs, the weight buffers and biases it read and what the kernel gave,
    for :func:`_kb1_against_plain` after the path's counts were read."""
    real_fwd, real_bwd = mlp_train_fused._fwd, mlp_train_fused._bwd
    keep = lambda *ts: [t.detach().clone() if torch.is_tensor(t) else t
                        for t in ts]
    first = lambda key, pts: key not in records and pts.is_cuda \
        and not torch.cuda.is_current_stream_capturing()

    def fwd(bf16, params, ls, pts, dirs, save_u, packed, biases):
        out = real_fwd(bf16, params, ls, pts, dirs, save_u, packed, biases)
        if first(("fwd", bf16, pts.shape[0]), pts):
            records["fwd", bf16, pts.shape[0]] = keep(ls, pts, dirs, packed,
                                                      biases, out[0])
        return out

    def bwd(bf16, params, params_t, ls, pts, dirs, g, ws, with_dw, packed_t,
            biases, du=None):
        out = real_bwd(bf16, params, params_t, ls, pts, dirs, g, ws, with_dw,
                       packed_t, biases, du)
        if first(("bwd", bf16, pts.shape[0]), pts):
            records["bwd", bf16, pts.shape[0]] = keep(
                ls, pts, dirs, packed_t, biases, out, g, with_dw)
        return out
    stack = contextlib.ExitStack()
    stack.enter_context(swapped(mlp_train_fused, "_fwd", fwd))
    stack.enter_context(swapped(mlp_train_fused, "_bwd", bwd))
    return stack


def _kb1_against_plain(records, dev):
    """Each recorded K-B1 launch of the bench against its plain version on
    the same inputs and the bench's teacher (the solid one with its scales),
    whose weight buffers and biases the launch must have read: float32 at
    phase 20's bars (raw within 1e-3, gradients by :func:`grad_errors`),
    bf16 in units of the bf16-to-float32 distance, or equal where the plain
    bf16 and float32 versions agree bit for bit."""
    shown = []
    for (kind, bf16, n), rec in sorted(records.items()):
        cfg = nerf.NeRFConfig(compute_dtype=torch.bfloat16 if bf16
                              else torch.float32)
        tensors = mlp_train_fused._layer_tensors(nerf.init_lsa_scales(
            synthetic.make_solid_mlp(cfg, device=dev)))
        weights, biases = tensors[0::3], tensors[1::3]
        params, params_t, _ = mlp_train_fused.pack_train(
            weights, biases, tensors[2::3])
        packs = (mlp_train_fused.pack_train_bf16 if bf16
                 else mlp_train_fused.pack_train_wgmma)(weights)
        form = mlp_train_fused._FORMS[bf16]
        ls, pts, dirs, packed, bias, got = rec[:6]
        what = f"K-B1 {'bf16 ' if bf16 else ''}{kind} at {n} bench points"
        check(torch.equal(packed, packs[kind == "bwd"]) and torch.equal(
            bias, torch.cat([b.float() for b in biases])),
            f"{what}: the launch read other weights than the bench's teacher")
        if kind == "fwd":
            plain = form["fwd_plain"](params, ls, pts, dirs)
            plain32 = mlp_train_fused.mlp_train_fwd_plain(params, ls, pts,
                                                          dirs)
            if bf16:
                shown.append(f"{what}: raw " + _bf16_held(what, got, plain,
                                                          plain32))
                continue
            err = maxabs(got, plain)
            check(err <= 1e-3, f"{what}: max |draw| {err}")
            shown.append(f"{what}: max|draw| {err:.3e}")
            continue
        g, with_dw = rec[6:]
        plain = form["bwd_plain"](params, params_t, ls, pts, dirs, g,
                                  with_dw)
        if bf16:
            plain32 = mlp_train_fused.mlp_train_bwd_plain(
                params, params_t, ls, pts, dirs, g, with_dw)
            if torch.equal(plain, plain32):
                check(torch.equal(got, plain), f"{what}: the plain bf16 and "
                      f"float32 gradients agree bit for bit and the kernel "
                      f"parts from them")
                shown.append(f"{what}: gradients equal to the plain bf16 "
                             f"version, itself equal to float32")
                continue
            shown.append(f"{what}: gradients " + str(grads_to_bf16_distance(
                what, got, plain, plain32, with_dw)))
            continue
        err_g, _abs, ok = grad_errors(
            mlp_train_fused.split_grads(got, with_dw),
            mlp_train_fused.split_grads(plain, with_dw))
        check(ok, f"{what}: gradients {err_g} of their max")
        shown.append(f"{what}: gradients {err_g:.3e} of their max (largest "
                     f"|g| {float(plain.abs().max()):.3e})")
    return shown


def phase_bench(dev, card):
    """Phase 24: the port's bench in float32 and bf16 as its command line,
    with cut iterations; each run's first K-B1 and K-B2 launch of each
    shape, and its first K-B3 launch whose raw holds a positive density,
    held against the plain versions after it."""
    launches, lines = {}, {}
    for tname, kernels in BENCH_KERNELS.items():
        kb1, kb2, kb3 = {}, {}, {}
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        with _kb1_recorded(kb1), _kb2_recorded(kb2), \
                _kb3_recorded(kb3, dense=True):
            line = port_bench.main(["--dtype", tname, *BENCH_ARGV])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _build.launch_counts()
        mine = {k: counts[k] for k in kernels}
        check(all(n > 0 for n in mine.values()) and not any(
            n for k, n in counts.items() if k not in mine),
            f"the bench ({tname}) launched {counts}")
        for k, n in mine.items():
            launches[k] = launches.get(k, 0) + n
        check(len(kb1) == 6, f"the bench's K-B1 launches recorded ({tname}): "
              f"{sorted(kb1)}")
        check(len(kb3) == 1, f"the bench's K-B3 launches that met the "
              f"solid, recorded ({tname}): {sorted(kb3)}")
        held = (_kb2_against_plain(kb2, dev) + _kb3_against_plain(kb3, dev)
                + _kb1_against_plain(kb1, dev))
        em = line["extra_metrics"]
        solid = em["fast_mode_min_devpsnr_posesweep"]
        turbo = em["fast_mode_min_devpsnr_turbo_sub8"]
        check(solid >= OCC_SOLID_MIN, f"bench ({tname}): solid devPSNR "
              f"{solid} dB (bar {OCC_SOLID_MIN})")
        check(np.isfinite(turbo) and turbo > BENCH_TURBO_MIN,
              f"bench ({tname}): turbo devPSNR {turbo} dB")
        check(np.isfinite(list(_numbers(line))).all(),
              f"bench ({tname}): a number that is not finite: {line}")
        print(f"[24] bench {' '.join(BENCH_ARGV)}, {tname}, on {card}: "
              f"{seconds:.1f} s, launches {mine}; frame {line['value']:.0f} "
              f"rays/s; devPSNR solid {solid} dB (bar {OCC_SOLID_MIN}), "
              f"turbo {turbo} dB (the reference's {BENCH_REF_TURBO}); "
              f"against the plain versions: " + "; ".join(held))
        lines[tname] = line
    print("bench lines: " + json.dumps(lines))
    return launches


def phase_ipe(dev, card):
    """Phase 25: K-B1's IPE instantiation (mip-NeRF) against its plain
    versions at a mip-NeRF step's 1,048,576 points and a tenth of them
    (the forward's raw within TOL_RAW, the backward's dls and db by phase
    20's gradient criterion, its rerun bit-equal), timed in turns with the vanilla instantiation on as many points (the
    share of the 165 TFLOP/s bound beside each); then 9 LSA steps of
    mip-NeRF's two-level loss through ``tune_lsa_scales`` in one call of 8
    (a graph) and in single steps: the scales bit-equal, the launches the
    IPE instantiation's only. Prints the ``ipe:`` JSON line."""
    g = torch.Generator().manual_seed(25)
    model = nerf.init_lsa_scales(synthetic._activate(
        nerf.init_params(nerf.MIPNERF, g), g), std=0.05, generator=g).to(dev)
    vanilla = nerf.init_lsa_scales(synthetic._activate(
        nerf.init_params(nerf.NeRFConfig(), g), g), std=0.05,
        generator=g).to(dev)
    M = mlp_train_fused
    out = {}
    for n in N_IPE:
        rays = n // 128
        ro = torch.randn(rays, 3, generator=g)
        ro = 4 * ro / torch.linalg.norm(ro, dim=-1, keepdim=True)
        rd = -ro / 4 + 0.1 * torch.randn(rays, 3, generator=g)
        t = mipnerf.stratified(2.0, 6.0, 129, rays,
                               torch.rand(rays, 129, generator=g), "cpu")
        means, covs = mipnerf.cast(t, ro, rd, 2 / (math.sqrt(12) * 1111.111))
        pts6 = torch.cat([means, covs], -1).reshape(-1, 6).to(dev)
        vd = (rd / torch.linalg.norm(rd, dim=-1, keepdim=True))[:, None] \
            .expand(rays, 128, 3).reshape(-1, 3).contiguous().to(dev)
        pts3 = means.reshape(-1, 3).contiguous().to(dev)
        cot = (1e-3 * torch.randn(n, 4, generator=g)).to(dev)
        row = {}
        for name, m, pts in (("ipe", model, pts6), ("vanilla", vanilla,
                                                    pts3)):
            tensors = M._layer_tensors(m)
            params, params_t, ls = M.pack_train(
                tensors[0::3], tensors[1::3], tensors[2::3])
            packed, packed_t = M.pack_train_wgmma(tensors[0::3])
            biases = M.gather_biases(params)
            raw, ws = M.mlp_train_fwd(params, ls, pts, vd, True, packed,
                                      biases)
            fwd = lambda: M.mlp_train_fwd(params, ls, pts, vd, True, packed,
                                          biases)
            bwd = lambda: M.mlp_train_bwd(params, params_t, ls, pts, vd, cot,
                                          ws, False, packed_t, biases)
            if name == "ipe":
                err = maxabs(raw, M.mlp_train_fwd_plain(params, ls, pts, vd))
                check(err <= TOL_RAW, f"K-B1 IPE forward at {n}: max |draw| "
                      f"{err} > {TOL_RAW}")
                row["err_raw"] = err
                # dls and db by phase 20's gradient criterion, and a rerun
                # bit-equal
                flat = bwd()
                err_g, _abs, ok = grad_errors(
                    M.split_grads(flat, False),
                    M.split_grads(M.mlp_train_bwd_plain(
                        params, params_t, ls, pts, vd, cot, False), False))
                check(torch.isfinite(flat).all().item() and ok,
                      f"K-B1 IPE backward at {n}: gradients off the plain "
                      f"version's (worst {err_g:.3e} of their max)")
                check(torch.equal(bwd(), flat),
                      f"K-B1 IPE backward at {n} not deterministic")
                row["err_grad"] = err_g
                del flat
                torch.cuda.empty_cache()
            macs = (IPE_FWD_MACS if name == "ipe" else KB1_FWD_MACS,
                    IPE_BWD_MACS)
            for part, fn, mac in (("fwd", fwd, macs[0]), ("bwd", bwd,
                                                          macs[1])):
                ms = [cuda_ms(fn, iters=3, warmup=1) for _ in range(2)]
                bound = 2 * mac * n / 165e12 * 1e3
                row[f"{name}_{part}_ms"] = min(ms)
                row[f"{name}_{part}_share"] = 100 * bound / min(ms)
            del raw, ws, params, params_t, fwd, bwd
            torch.cuda.empty_cache()
        print(f"[25] K-B1 at {n} points on {card}: IPE fwd "
              f"{row['ipe_fwd_ms']:.3f} ms ({row['ipe_fwd_share']:.1f}% of "
              f"165 TFLOP/s), bwd {row['ipe_bwd_ms']:.3f} ms "
              f"({row['ipe_bwd_share']:.1f}%); vanilla fwd "
              f"{row['vanilla_fwd_ms']:.3f} ms, bwd "
              f"{row['vanilla_bwd_ms']:.3f} ms; against the plain version "
              f"IPE raw {row['err_raw']:.2e}, gradients {row['err_grad']:.2e} "
              f"of their max (bar: phase 20's criterion)")
        out[n] = row
    # LSA: 9 steps, calls of 8 (step 1 alone, then a graph) and of 1
    rng = np.random.default_rng(25)
    images = rng.random((2, 96, 96, 3), dtype=np.float32)
    poses = synthetic.look_at_poses(2, seed=25)
    K = presets.pixel_centres(presets._intrinsics(96, 96, 133.3))
    rc = mipnerf.MipRenderConfig(num_samples=IPE_LSA_SAMPLES,
                                 pixel_radius=2 / (math.sqrt(12) * 133.3))
    scales = []
    for k in (8, 1):
        m = nerf.init_lsa_scales(synthetic._activate(
            nerf.init_params(nerf.MIPNERF, torch.Generator().manual_seed(5)),
            torch.Generator().manual_seed(6))).to(dev)
        _build.reset_launch_counts()
        ls, _f, _p, _l, _s, _b = lsa.tune_lsa_scales(
            m, None, RayBatcher(images, poses, K, np.arange(2),
                                IPE_LSA_RAYS, seed=3), rc, 2.0, 6.0,
            n_iters=9, epochs=1,
            learning_rate=1e-3, learning_rate_decay=0.0, verbose=False,
            steps_per_call=k, seed=7)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        warm = lsa.WARMUP_STEPS if k > 1 else 0
        want = {"mlp_train_fwd_ipe": 2 * (9 + warm),
                "mlp_train_bwd_ipe": 2 * (9 + warm)}
        check({n: c for n, c in counts.items() if c} == want,
              f"mip-NeRF LSA (calls of {k}) launched {counts}")
        scales.append(ls)
    check(all(torch.equal(scales[0][n], scales[1][n]) for n in scales[0]),
          "mip-NeRF LSA: calls of 8 and single steps differ")
    print(f"[25] mip-NeRF LSA, 9 steps of {IPE_LSA_RAYS} rays: calls of 8 "
          f"== single steps bit for bit, K-B1 IPE launches only")
    # the normal path: compress_model(lsa=True) on a mip-NeRF scene
    mip_dir = os.path.join(OUT, "mip")
    bs = os.path.join(mip_dir, "bitstream", "mip_lsa.nnc")
    os.makedirs(os.path.dirname(bs), exist_ok=True)
    scene = {"images": images, "poses": poses, "K": K, "H": 96, "W": 96,
             "i_train": np.arange(2), "i_test": np.arange(1), "near": 2.0,
             "far": 6.0, "white_bkgd": True, "ndc": False,
             "batching_mode": "image", "dataset_type": "blender",
             "mip": {"num_samples": IPE_LSA_SAMPLES}}
    teacher = nerf.params_to_state_dict(nerf.init_params(
        nerf.MIPNERF, torch.Generator().manual_seed(8)), "model.")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    nnc_tpu_torch.compress_model(teacher, bitstream_path=bs, qp=-20,
                                 lsa=True, scene=scene, N_iters=17,
                                 epochs=1, i_save=17, N_rand=IPE_LSA_RAYS,
                                 learning_rate=1e-3, use_fused_mlp=True,
                                 device=dev, verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    dec = nnc_tpu_torch.decompress_model(bs, verbose=False)
    ex = presets.create_nerf_model_executer(scene=scene, device=dev,
                                            use_fused_mlp=True,
                                            verbose=False)
    psnr = ex.test_model(dec)
    torch.cuda.synchronize()
    counts = {n: c for n, c in _build.launch_counts().items() if c}
    check(set(counts) == {"mlp_train_fwd_ipe", "mlp_train_bwd_ipe"} and
          counts["mlp_train_bwd_ipe"] == 2 * (17 + lsa.WARMUP_STEPS),
          f"mip-NeRF compress_model(lsa=True) launched {counts}")
    check(set(dec) == set(teacher) and np.isfinite(psnr),
          f"mip-NeRF decode: {sorted(set(dec) ^ set(teacher))}, {psnr} dB")
    check(os.path.exists(os.path.join(mip_dir, "reconstructed",
                                      "ckpt_step17.pt")) and
          os.path.exists(os.path.join(mip_dir, "testset_step17", "000.png")),
          "mip-NeRF i_save checkpoint or test PNG missing")
    print(f"[25] mip-NeRF compress_model(lsa=True), 17 steps of "
          f"{IPE_LSA_RAYS} rays, on {card}: {seconds:.1f} s, launches "
          f"{counts}, decoded test view {psnr:.2f} dB")
    print("ipe: " + json.dumps({str(n): r for n, r in out.items()}))


def _mip360_teacher(seed):
    """mip-NeRF 360's two MLPs at the published widths in the port's state
    dict layout (the proposal MLP as ``model.*``, the NeRF MLP as
    ``model_fine.*``): each layer U(-1/sqrt(in), 1/sqrt(in)), the density
    layers x20 and the rgb layer x10 (visible density and colour)."""
    from nnc_tpu_torch.models import mipnerf360 as m360
    g = torch.Generator().manual_seed(seed)
    tree = {}
    for key, cfg in (("prop_mlp", m360.PROP_MLP), ("nerf_mlp",
                                                   m360.NERF_MLP)):
        tree[key] = {}
        for i, (d_in, d_out) in enumerate(m360.layer_dims(cfg).values()):
            b = 1 / math.sqrt(d_in)
            tree[key][f"Dense_{i}"] = {
                "kernel": (torch.rand(d_in, d_out, generator=g) * 2 - 1) * b,
                "bias": (torch.rand(d_out, generator=g) * 2 - 1) * b}
        tree[key][f"Dense_{cfg.depth}"]["kernel"].mul_(20.0)
        if cfg.rgb:
            tree[key][f"Dense_{cfg.depth + 3}"]["kernel"].mul_(10.0)
    prop, mlp = m360.from_mipnerf360_params(tree)
    return prop, mlp, {**nerf.params_to_state_dict(prop, "model."),
                       **nerf.params_to_state_dict(mlp, "model_fine.")}


def _kb7_held(what, got, want, bar):
    """The worst of |got - want| / bar(want) (held at most 1)."""
    worst = float(((got - want).abs() / bar).max())
    check(worst <= 1.0, f"K-B7 {what}: {worst:.3f} of its bar")
    return worst


def phase_kb7(dev, card):
    """Phase 26: K-B7 against its plain versions at a mip-NeRF 360 step's
    shapes, timed; mip-NeRF 360's LSA and compress_model(lsa=True) at the
    published widths launching K-B7 only. Prints the ``kb7:`` JSON line."""
    from nnc_tpu_torch.models import mipnerf360 as m360
    from nnc_tpu_torch.ops import lsa_epilogue as E
    from nnc_tpu_torch.render import mipnerf360
    g = torch.Generator(device=dev).manual_seed(26)
    out = {}
    for n, c in N_KB7:
        r = lambda *shape: torch.randn(*shape, generator=g, device=dev)
        acc, dy, s, b = r(n, c), r(n, c), 1 + 0.1 * r(c), 0.1 * r(c)
        y = E.epilogue_fwd(acc, s, b, True)
        want_y = E.epilogue_fwd_plain(acc, s, b, True)
        row = {"fwd_err": maxabs(y, want_y),
               "fwd_worst": _kb7_held("forward", y, want_y,
                                      2e-6 + 2e-6 * want_y.abs())}
        check(torch.equal(E.epilogue_fwd(acc, s, b, True), y),
              f"K-B7 forward at {n} x {c} not deterministic")
        del want_y
        got = E.epilogue_bwd(dy, acc, s, b, True)
        want = E.epilogue_bwd_plain(dy, acc, s, b, True)
        row["dacc_err"] = maxabs(got[0], want[0])
        row["dacc_worst"] = _kb7_held("dacc", got[0], want[0],
                                      2e-6 + 2e-6 * want[0].abs())
        mask = acc * s + b > 0
        for k, name, terms in ((1, "ds", dy * acc * mask),
                               (2, "db", dy * mask)):
            row[f"{name}_worst"] = _kb7_held(
                name, got[k], want[k], 1e-5 * terms.abs().sum(0) + 1e-6)
            del terms
        del want, mask
        again = E.epilogue_bwd(dy, acc, s, b, True)
        check(all(torch.equal(a, b_) for a, b_ in zip(got, again)),
              f"K-B7 backward at {n} x {c} not deterministic")
        del got, again
        torch.cuda.empty_cache()
        parts = (("fwd", lambda: E.epilogue_fwd(acc, s, b, True),
                  lambda: E.epilogue_fwd_plain(acc, s, b, True),
                  2 * 4 * n * c, 2 * n * c),
                 ("bwd", lambda: E.epilogue_bwd(dy, acc, s, b, True),
                  lambda: E.epilogue_bwd_plain(dy, acc, s, b, True),
                  3 * 4 * n * c, 4 * n * c))
        for part, kernel, plain, n_bytes, ops in parts:
            k_ms, p_ms = [], []
            for _ in range(2):       # in turns
                k_ms.append(cuda_ms(kernel, iters=5, warmup=1))
                p_ms.append(cuda_ms(plain, iters=5, warmup=1))
            torch.cuda.empty_cache()
            row[f"{part}_ms"], row[f"{part}_plain_ms"] = min(k_ms), min(p_ms)
            row[f"{part}_bound_ms"] = bound(n_bytes, ops,
                                            PEAK_FP32)["bound_ms"]
            row[f"{part}_share"] = 100 * row[f"{part}_bound_ms"] / min(k_ms)
        w = r(c, c)
        with E._fp32_products():
            row["gemm_ms"] = cuda_ms(lambda: torch.mm(acc, w.t()), iters=3,
                                     warmup=1)
        print(f"[26] K-B7 at {n} x {c} on {card}: fwd {row['fwd_ms']:.3f} ms "
              f"(plain {row['fwd_plain_ms']:.3f}, bound "
              f"{row['fwd_bound_ms']:.3f}, {row['fwd_share']:.1f}%), bwd "
              f"{row['bwd_ms']:.3f} ms (plain {row['bwd_plain_ms']:.3f}, "
              f"bound {row['bwd_bound_ms']:.3f}, {row['bwd_share']:.1f}%); "
              f"the layer's cuBLAS GEMM {row['gemm_ms']:.3f} ms; against "
              f"the plain versions y {row['fwd_err']:.2e}, dacc "
              f"{row['dacc_err']:.2e}, worst of their bars: "
              f"{max(v for k, v in row.items() if k.endswith('_worst')):.3f}")
        out[f"{n}x{c}"] = row
        del acc, dy, s, b, y, w
        torch.cuda.empty_cache()
    # the main path: 9 LSA steps of mip-NeRF 360, a call of 8 (a graph,
    # captured after one warm-up step) and a single step
    rng = np.random.default_rng(26)
    images = rng.random((2, 32, 48, 3), dtype=np.float32)
    poses = synthetic.look_at_poses(2, seed=26)
    K = presets.pixel_centres(presets._intrinsics(32, 48, 40.0))
    rc = mipnerf360.make_render_config({"K": K})
    prop, mlp, teacher = _mip360_teacher(26)
    prop, mlp = prop.to(dev), mlp.to(dev)
    per_step = 2 * (len(mlp.layers()) + 2 * len(prop.layers()))
    _build.reset_launch_counts()
    lsa.tune_lsa_scales(
        prop, mlp, RayBatcher(images, poses, K, np.arange(2), KB7_LSA_RAYS,
                              mode="pool", seed=3), rc, 0.2, 1e6,
        n_iters=9, epochs=1, learning_rate=1e-3, learning_rate_decay=0.0,
        verbose=False, seed=7)
    torch.cuda.synchronize()
    counts = {n: c for n, c in _build.launch_counts().items() if c}
    want = {"lsa_epilogue": per_step * (9 + lsa.WARMUP_STEPS)}
    check(counts == want, f"mip-NeRF 360 LSA launched {counts}, not {want}")
    check(all(bool(torch.isfinite(l.weight_scaling).all())
              for m in (prop, mlp) for l in m.layers().values()),
          "mip-NeRF 360 LSA: scales not finite")
    print(f"[26] mip-NeRF 360 LSA, 9 steps of {KB7_LSA_RAYS} rays at the "
          f"published widths: launches {counts} ({per_step} a step)")
    del prop, mlp
    torch.cuda.empty_cache()
    # the normal path: compress_model(lsa=True) on a mip-NeRF 360 scene
    m360_dir = os.path.join(OUT, "mip360")
    bs = os.path.join(m360_dir, "bitstream", "mip360_lsa.nnc")
    os.makedirs(os.path.dirname(bs), exist_ok=True)
    scene = {"images": images, "poses": poses, "K": K, "H": 32, "W": 48,
             "i_train": np.arange(2), "i_test": np.arange(1), "near": 0.2,
             "far": 1e6, "white_bkgd": False, "ndc": False,
             "raw_noise_std": 0.0, "batching_mode": "pool",
             "dataset_type": "llff", "mip360": {}}
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    nnc_tpu_torch.compress_model(teacher, bitstream_path=bs, qp=-20,
                                 lsa=True, scene=scene, N_iters=17,
                                 epochs=1, i_save=17, N_rand=KB7_LSA_RAYS,
                                 learning_rate=1e-3, device=dev,
                                 verbose=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = {n: c for n, c in _build.launch_counts().items() if c}
    tuned = per_step * (17 + lsa.WARMUP_STEPS)
    views = counts.get("lsa_epilogue", 0) - tuned
    check(set(counts) == {"lsa_epilogue"} and views >= 0 and
          views % (per_step // 2) == 0,
          f"mip-NeRF 360 compress_model(lsa=True) launched {counts} "
          f"({tuned} for the tuning, then {per_step // 2} a chunk)")
    dec = nnc_tpu_torch.decompress_model(bs, verbose=False)
    check(set(dec) >= set(teacher),
          f"mip-NeRF 360 decode: {sorted(set(teacher) - set(dec))} missing")
    print(f"[26] mip-NeRF 360 compress_model(lsa=True), 17 steps of "
          f"{KB7_LSA_RAYS} rays, on {card}: {seconds:.1f} s, launches "
          f"{counts} ({tuned} tuning, {views} in test views)")
    print("kb7: " + json.dumps(out))


def _numbers(tree):
    """Every number in a tool's result, depth first (None skipped)."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _numbers(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _numbers(v)
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        yield tree


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    t_start = time.perf_counter()
    seconds = []
    try:
        return run_phases(t_start, seconds)
    finally:
        if SASS_DUMP is not None and SASS_DUMP.poll() is None:
            SASS_DUMP.kill()
            SASS_DUMP.wait()


def run_phases(t_start, seconds):

    def phase(fn, *args):
        """fn(*args), its wall seconds appended to ``seconds``."""
        t0 = time.perf_counter()
        out = fn(*args)
        seconds.append(time.perf_counter() - t0)
        return out

    dev, card = phase(phase_environment)
    row, ctx = phase(phase_mlp, dev)
    rows = {"mlp_from_points": row, "render_pass": phase(phase_render, dev)}
    # resets the launch counts first
    scene, sd, tar, dec, psnr_f32 = phase(phase_slice, dev)
    scene_ndc, sd_ndc, psnr_kb3 = phase(phase_llff, dev)
    launches = {k: _build.launch_counts()[k] for k in RENDER_KERNELS}
    rows.update(phase(phase_train_kernels, dev))
    # (resets the launch counts first)
    lsa_launches, dec0, sets, ls32, psnr_lsa32 = phase(phase_lsa, dev, scene,
                                                       sd, tar)
    launches.update(lsa_launches)
    rows["mlp_embedded"] = phase(phase_embedded, dev, ctx)
    rows["mlp_int8_from_points"] = phase(phase_int8, dev, ctx)
    launches.update(phase(phase_lowprec_slice, dev, scene_ndc, sd_ndc,
                          psnr_kb3))
    rows["mlp_tp_pair"] = phase(phase_tp_pair, dev)
    launches["mlp_tp_pair"] = phase(phase_tp_slice, dev, scene_ndc, sd_ndc)
    mesh_launches, dry_pairs = phase(phase_multi_device, dev, scene, dec0,
                                     sets)
    launches["mlp_tp_pair"] += dry_pairs
    rows.update(phase(phase_bf16_kernels, dev, ctx))
    bf16_launches, psnr_ndc16 = phase(phase_bf16_slice, dev, scene, dec,
                                      psnr_f32, scene_ndc, sd_ndc, tar)
    launches.update(bf16_launches)
    rows.update(phase(phase_train_bf16_kernels, dev))
    # (its float32 bench_train_step launches the float32 forward once more)
    for name, n in phase(phase_lsa_bf16, dev, scene, tar, dec0, sets, ls32,
                         psnr_lsa32).items():
        launches[name] = launches.get(name, 0) + n
    rows.update(phase(phase_bf16_tp_kernels, dev, ctx))
    del ctx
    launches.update(phase(phase_bf16_tp_slice, dev, scene_ndc, sd_ndc,
                          psnr_ndc16))
    # (resets the launch counts first)
    for name, n in phase(phase_occupancy, dev, scene, sd, tar, dec0).items():
        launches[name] = launches.get(name, 0) + n
    phase(phase_scan, dev, scene, sd, dec0, card)
    # (resets the launch counts before each of its paths)
    for name, n in phase(phase_tools, dev, scene, dec0, card).items():
        launches[name] = launches.get(name, 0) + n
    # (resets the launch counts before each tool's run)
    for name, n in phase(phase_render_tools, dev, card, scene).items():
        launches[name] = launches.get(name, 0) + n
    # (resets the launch counts before each of its runs)
    for name, n in phase(phase_bench, dev, card).items():
        launches[name] = launches.get(name, 0) + n
    phase(phase_ipe, dev, card)
    phase(phase_kb7, dev, card)
    print("seconds per phase: " + ", ".join(
        f"{i} {t:.1f}" for i, t in enumerate(seconds, 1)))
    for name, n in mesh_launches.items():
        check(n > 0, f"the multi-device slice did not launch {name}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
    kernels = [{"name": name, "route": "cuda",
                "source": KERNEL_ROWS[name][0],
                "replaces": KERNEL_ROWS[name][1],
                "launches": launches[name], **rows[name]}
               for name in KERNEL_ROWS]
    print(f"total {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
