"""Multi-scene LSA driver (BASELINE.md config 5).

Counterpart of ``tools/multi_scene.py``, with its flags, defaults and
printed JSON lines. Tunes several scenes' models together
(``parallel/multi_scene.tune_multi_scene``); where the CUDA devices divide
over the scenes, each group of devices owns one scene on a ('scene',
'data') mesh, else every scene steps on the one device in turn. The
flagship architecture trains through K-B1. Falls back to synthetic scenes
when no checkpoints/datasets are given. The device is the one
``NNC_TPU_TORCH_DEVICE`` names, else the first CUDA device.

Usage:
  python -m nnc_tpu_torch.tools.multi_scene --synthetic --n-scenes 2 \
      --iters 200
  python -m nnc_tpu_torch.tools.multi_scene --ckpts lego.tar fern.tar \
      --datasets blender llff --iters 500
"""
from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpts", nargs="*", default=None)
    ap.add_argument("--datasets", nargs="*", default=None)
    ap.add_argument("--dataset-paths", nargs="*", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--n-scenes", type=int, default=2)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--n-rand", type=int, default=1024)
    args = ap.parse_args(argv)

    import torch

    from nnc_tpu_torch.data.rays import RayBatcher
    from nnc_tpu_torch.models import nerf
    from nnc_tpu_torch.parallel import multi_scene
    from nnc_tpu_torch.render import renderer
    from nnc_tpu_torch.utils.platform import device_from_env

    device = device_from_env()
    # the kernels where the architecture has them (K-B1 for the steps)
    fused = dict(use_fused_mlp=True, use_fused_compositing=True,
                 use_fused_train=True)
    if args.synthetic:
        from nnc_tpu_torch.data import synthetic
        mlp = nerf.NeRFConfig(W=64)
        rc = renderer.RenderConfig(mlp=mlp, n_samples=32, n_importance=16,
                                   chunk=2048, **fused)
        scenes, models_list = [], []
        for i in range(args.n_scenes):
            scene, models = synthetic.make_scene(n_images=4, H=32, W=32,
                                                 mlp=mlp, rc=rc, seed=i,
                                                 device=device)
            scene["n_importance"] = 16
            scenes.append(scene)
            models_list.append(models)
    else:
        if not (args.ckpts and args.datasets):
            ap.error("--ckpts and --datasets required without --synthetic")
        from nnc_tpu_torch.train.presets import load_scene
        from nnc_tpu_torch.utils import ckpt as cku
        mlp = nerf.NeRFConfig()
        scenes, models_list = [], []
        paths = args.dataset_paths or [None] * len(args.ckpts)
        for ck, ds, dp in zip(args.ckpts, args.datasets, paths):
            wrapper, _ = cku.nerf_tar_to_wrapper_dict(ck)
            # the scales start at identity, as the reference's do
            wrapper = {k: v for k, v in wrapper.items()
                       if not k.endswith(".weight_scaling")}
            models_list.append(tuple(
                nerf.params_from_state_dict(wrapper, p, mlp, device=device)
                for p in ("model.", "model_fine.")))
            scenes.append(load_scene(ds, dp))
        rc = renderer.RenderConfig(
            mlp=mlp, n_samples=64,
            n_importance=int(max(s.get("n_importance", 128)
                                 for s in scenes)), **fused)

    n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
    mesh = None
    if n_dev % len(scenes) == 0 and n_dev >= len(scenes):
        mesh = multi_scene.make_scene_mesh(len(scenes), n_dev)
        print(f"mesh: {dict(mesh.shape)} over {n_dev} devices")
        models_list = [tuple(m.to(mesh.devices[i][0]) for m in models)
                       for i, models in enumerate(models_list)]

    batchers = [RayBatcher(s["images"], s["poses"], s["K"], s["i_train"],
                           args.n_rand, mode=s.get("batching_mode", "image"),
                           seed=i)
                for i, s in enumerate(scenes)]

    _tuned, psnrs = multi_scene.tune_multi_scene(
        scenes, models_list, rc, batchers=batchers,
        learning_rate=args.lr, n_iters=args.iters, mesh=mesh)
    for i, p in enumerate(psnrs):
        print(json.dumps({"scene": i, "train_psnr": p}))
    return psnrs


if __name__ == "__main__":
    main()
