"""Rate-distortion sweep harness: qp in {...} x {lsa on/off}.

Counterpart of ``tools/rd_sweep.py``, with its flags, defaults and record
fields. For each operating point: compress -> decompress -> render the
scene's test views -> record (bitstream bytes, PSNR); writes
rd_results.json, and an RD curve plot where matplotlib imports. Implements
the reference evaluation protocol of BASELINE.md config 4 (result.txt +
grapher curves per run); ``merge_rd`` merges sweeps. The device is the one
``NNC_TPU_TORCH_DEVICE`` names, else the first CUDA device.

Usage:
  python -m nnc_tpu_torch.tools.rd_sweep --ckpt lego_200000.tar \
      --dataset blender --qps -10 -20 -30 -38 --out ./rd_runs \
      [--lsa-iters 500]
  python -m nnc_tpu_torch.tools.rd_sweep --synthetic   # no datasets
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os

import numpy as np


def run_point(wrapper_dict, scene, mlp_cfg, qp, lsa, out_dir, n_iters,
              epochs, use_fused, device, ioq=False, ioq_codebook=False,
              scene_name="synthetic"):
    import nnc_tpu_torch
    from nnc_tpu_torch.train.presets import create_nerf_model_executer

    tag = (f"qp{qp}_lsa{int(lsa)}" + ("_ioq" if ioq else "")
           + ("cb" if ioq_codebook else ""))
    run_dir = os.path.join(out_dir, tag)
    os.makedirs(os.path.join(run_dir, "bitstream"), exist_ok=True)
    bs_path = os.path.join(run_dir, "bitstream", "bitstream.nnc")

    ex = create_nerf_model_executer(
        scene=scene, device=device, mlp_config=mlp_cfg, n_iters=n_iters,
        epochs=epochs, i_save=0, use_fused_mlp=use_fused, verbose=False)

    nnc_tpu_torch.compress_model(
        wrapper_dict, bitstream_path=bs_path, qp=qp, lsa=lsa, ioq=ioq,
        ioq_codebook=ioq_codebook,
        model_executer=ex if (lsa or ioq) else None, scene=scene,
        mlp_config=mlp_cfg, N_iters=n_iters, epochs=epochs, i_save=0,
        verbose=False, use_fused_mlp=use_fused, device=device)
    rec = nnc_tpu_torch.decompress(bs_path, verbose=False)
    psnr = ex.test_model(rec)
    nbytes = os.path.getsize(bs_path)
    extra = {}
    holdout = scene.get("i_holdout")
    if holdout is not None and len(holdout):
        # probe-overfit check: the IOQ search only ever sees i_train ray
        # batches (eval_model); render poses that neither the probe nor the
        # headline PSNR (i_test) used, so a search that overfits its pose
        # selection shows up as a flat-vs-ioq gap that shrinks here
        model_c, model_f = ex._split_params(rec)
        _, ps = ex._render_views(model_c, model_f, holdout)
        extra["psnr_holdout"] = float(np.mean(ps))
    return {"qp": qp, "lsa": lsa, "bytes": nbytes, "psnr": psnr, **extra,
            "lsa_iters": n_iters, "epochs": epochs,
            "mode": ("ioq+cb" if (ioq and ioq_codebook)
                     else "ioq" if ioq else "flat"),
            "scene": scene_name, "run_dir": run_dir}


def plot_rd(results, out_path):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(7, 5))
    for lsa in (False, True):
        pts = sorted([(r["bytes"] / 1024, r["psnr"]) for r in results
                      if r["lsa"] == lsa])
        if pts:
            ax.plot(*zip(*pts), marker="o",
                    label=f"LSA {'on' if lsa else 'off'}")
    ax.set_xlabel("bitstream size (KiB)")
    ax.set_ylabel("test PSNR (dB)")
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    print(f"saved {out_path}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--dataset", type=str, default="blender")
    ap.add_argument("--dataset-path", type=str, default=None)
    ap.add_argument("--qps", type=int, nargs="+",
                    default=[-10, -20, -30, -38])
    ap.add_argument("--out", type=str, default="./rd_runs")
    ap.add_argument("--lsa-iters", type=int, default=500)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--synthetic", action="store_true",
                    help="use a synthetic teacher scene (no datasets)")
    ap.add_argument("--synthetic-ndc", action="store_true",
                    help="use the forward-facing NDC teacher scene "
                         "(LLFF-geometry analog; no datasets)")
    ap.add_argument("--no-fused", action="store_true")
    ap.add_argument("--ioq", action="store_true",
                    help="add an inference-optimized per-tensor-QP series "
                         "(lsa off)")
    ap.add_argument("--ioq-codebook", action="store_true",
                    help="add an IOQ series with probe-arbitrated per-"
                         "tensor uniform-vs-codebook method choice "
                         "(mode 'ioq+cb')")
    ap.add_argument("--holdout-views", type=int, default=0,
                    help="synthetic scenes only: render N extra teacher "
                         "poses never seen by the probe or i_test and "
                         "record psnr_holdout per point (probe-overfit "
                         "check)")
    args = ap.parse_args(argv)

    from nnc_tpu_torch.models import nerf as nerf_mod
    from nnc_tpu_torch.render import renderer
    from nnc_tpu_torch.utils.platform import device_from_env

    device = device_from_env()
    if args.synthetic or args.synthetic_ndc:
        from nnc_tpu_torch.data import synthetic
        mlp_cfg = nerf_mod.NeRFConfig(W=64)
        maker = synthetic.make_scene_ndc if args.synthetic_ndc \
            else synthetic.make_scene
        scene, (tc, tf_) = maker(
            n_images=4 + args.holdout_views, H=32, W=32, mlp=mlp_cfg,
            rc=renderer.RenderConfig(mlp=mlp_cfg, n_samples=32,
                                     n_importance=16, chunk=1024),
            device=device)
        scene["n_importance"] = 16
        if args.holdout_views:
            # keep the standard 3-train/1-test split; the extra teacher
            # views become a pure holdout set (never probed, never tested)
            scene["i_train"] = np.arange(3)
            scene["i_test"] = np.array([3])
            scene["i_holdout"] = np.arange(4, 4 + args.holdout_views)
        wrapper = {}
        wrapper.update(nerf_mod.params_to_state_dict(tc, "model."))
        wrapper.update(nerf_mod.params_to_state_dict(tf_, "model_fine."))
    else:
        if not args.ckpt:
            ap.error("--ckpt required unless --synthetic[-ndc]")
        from nnc_tpu_torch.train.presets import load_scene
        from nnc_tpu_torch.utils import ckpt as cku
        wrapper, _ = cku.nerf_tar_to_wrapper_dict(args.ckpt)
        scene = load_scene(args.dataset, args.dataset_path)
        mlp_cfg = nerf_mod.NeRFConfig()

    os.makedirs(args.out, exist_ok=True)
    results = []
    for qp in args.qps:
        arms = [(False, False, False), (True, False, False)]
        if args.ioq:
            arms.append((False, True, False))
        if args.ioq_codebook:
            arms.append((False, True, True))
        scene_name = ("synthetic_ndc" if args.synthetic_ndc
                      else "synthetic" if args.synthetic else args.dataset)
        if args.holdout_views:
            # the extra teacher views change every pose (look_at_poses
            # depends on n); keep these points distinct from the standard
            # 4-view scene's
            scene_name += f"+holdout{args.holdout_views}"
        for lsa, ioq, ioq_cb in arms:
            r = run_point(wrapper, scene, mlp_cfg, qp, lsa, args.out,
                          args.lsa_iters, args.epochs, not args.no_fused,
                          device, ioq=ioq, ioq_codebook=ioq_cb,
                          scene_name=scene_name)
            print(json.dumps(r))
            results.append(r)

    with open(os.path.join(args.out, "rd_results.json"), "w") as f:
        json.dump(results, f, indent=2)
    if importlib.util.find_spec("matplotlib") is not None:
        plot_rd(results, os.path.join(args.out, "rd_curve.png"))
    return results


if __name__ == "__main__":
    main()
