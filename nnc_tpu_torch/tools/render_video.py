"""Render a spiral-path video from a nerf-pytorch ``.tar`` checkpoint.

Counterpart of ``tools/render_video.py``, with its flags and defaults. The
model computes in bf16. By default frames render in occupancy mode: the
grid is swept through K-B3 and each frame's compacted samples go through
K-B2 (``render/occupancy.py``); ``--exact`` renders the reference's
hierarchical path (K-B2 for both passes on the flagship architecture).
Writes PNG frames and a video through ``utils/video.write_video`` (mp4
where imageio has ffmpeg, else an MJPEG .avi where Pillow imports). The
device is the one ``NNC_TPU_TORCH_DEVICE`` names, else the first CUDA
device.

Usage:
  python -m nnc_tpu_torch.tools.render_video --ckpt lego_200000.tar \
      --dataset blender --dataset-path ./data/nerf_synthetic/lego \
      --out ./video [--exact]
  python -m nnc_tpu_torch.tools.render_video --synthetic --out ./video
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=None, help="nerf-pytorch .tar")
    ap.add_argument("--dataset", default="blender")
    ap.add_argument("--dataset-path", default=None)
    ap.add_argument("--synthetic", action="store_true",
                    help="render a synthetic teacher scene (no data needed)")
    ap.add_argument("--out", default="./video_out")
    ap.add_argument("--exact", action="store_true",
                    help="reference-semantics hierarchical render")
    ap.add_argument("--frames", type=int, default=None,
                    help="cap the number of spiral poses")
    ap.add_argument("--size", type=int, default=None,
                    help="override H=W render resolution")
    args = ap.parse_args(argv)

    import torch

    from nnc_tpu_torch.models import nerf
    from nnc_tpu_torch.render import occupancy, renderer
    from nnc_tpu_torch.render.rays import get_rays_np, ndc_rays
    from nnc_tpu_torch.train.presets import load_scene, make_render_config
    from nnc_tpu_torch.utils.ckpt import nerf_tar_to_wrapper_dict
    from nnc_tpu_torch.utils.images import write_png
    from nnc_tpu_torch.utils.logging import to8b
    from nnc_tpu_torch.utils.platform import device_from_env
    from nnc_tpu_torch.utils.video import write_video

    device = device_from_env()
    mlp = nerf.NeRFConfig(compute_dtype=torch.bfloat16)
    if args.synthetic:
        from nnc_tpu_torch.data.synthetic import look_at_poses, make_solid_mlp
        size = args.size or 128
        model_c = model_f = make_solid_mlp(mlp, device=device)
        f = 0.8 * size
        scene = {
            "H": size, "W": size,
            "K": np.array([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]],
                          np.float32),
            "render_poses": look_at_poses(30, seed=0),
            "near": 2.0, "far": 6.0, "white_bkgd": True, "ndc": False,
            "n_importance": 128,
        }
    else:
        if not args.ckpt:
            ap.error("--ckpt required without --synthetic")
        scene = load_scene(args.dataset, args.dataset_path)
        wrapper, _step = nerf_tar_to_wrapper_dict(args.ckpt)
        model_c = nerf.params_from_state_dict(wrapper, "model.", mlp,
                                              device=device)
        model_f = nerf.params_from_state_dict(wrapper, "model_fine.", mlp,
                                              device=device)
    rc = make_render_config(scene, mlp, use_fused_mlp=True)
    if args.size:
        scene["H"] = scene["W"] = args.size
        f = 0.8 * args.size
        scene["K"] = np.array([[f, 0, args.size / 2],
                               [0, f, args.size / 2], [0, 0, 1]], np.float32)

    poses = np.asarray(scene["render_poses"])
    if args.frames:
        poses = poses[:args.frames]
    H, W = scene["H"], scene["W"]
    near, far = scene["near"], scene["far"]
    use_fast = not args.exact and not scene.get("ndc", False)

    grid = None
    if use_fast:
        t0 = time.time()
        aabb = scene.get("aabb", ((-2.0,) * 3, (2.0,) * 3))
        grid = occupancy.build_occupancy_grid(model_f, lo=tuple(aabb[0]),
                                              hi=tuple(aabb[1]))
        print(f"occupancy grid built in {time.time() - t0:.1f}s "
              f"(occ {float(grid.occ.float().mean()):.3f})")

    os.makedirs(args.out, exist_ok=True)
    frames = []
    t0 = time.time()
    for i, pose in enumerate(poses):
        ro, rd = get_rays_np(H, W, scene["K"], pose[:3, :4])
        if use_fast:
            # rgb as uint8 on the device: 4x fewer device->host bytes; the
            # fast render composites the background itself
            out = occupancy.render_image_fast(
                model_f, ro, rd, near, far, rc, grid, outputs=("rgb_map",),
                rgb_uint8=True)
            rgb = out["rgb_map"].astype(np.float32) / 255.0
        else:
            vd = None
            if scene.get("ndc", False):
                vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
                ro, rd = (a.numpy() for a in ndc_rays(
                    H, W, float(scene["K"][0][0]), 1.0,
                    torch.from_numpy(ro), torch.from_numpy(rd)))
            out = renderer.render_image(model_c, model_f, ro, rd, near, far,
                                        rc, viewdirs=vd, device=device)
            rgb = out["rgb_map"].float().cpu().numpy()
        frames.append(rgb)
        if i == 0:
            t0 = time.time()   # exclude the first frame's set-up
        write_png(os.path.join(args.out, f"frame_{i:03d}.png"), to8b(rgb))
        rate = (f"({i * H * W / (time.time() - t0) / 1e6:.2f} M rays/s)"
                if i else "(first frame)")
        print(f"\rframe {i + 1}/{len(poses)} {rate}", end="", flush=True)
    print()

    frames8 = to8b(np.stack(frames))
    path = write_video(os.path.join(args.out, "spiral"), frames8, fps=30,
                       quality=8)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
