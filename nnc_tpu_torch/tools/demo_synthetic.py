"""Full-pipeline demo on a synthetic scene — no datasets required.

Counterpart of ``tools/demo_synthetic.py``, with its flags, defaults and
printed JSON keys. Runs the complete reference workflow at the flagship
model size: build a teacher NeRF scene -> save a nerf-pytorch style .tar ->
compress with LSA (rendering on the device; with ``--full-mlp`` the steps
run K-B1 and the test views K-B2) -> decompress -> convert back to .tar ->
report PSNR and sizes. The device is the one ``NNC_TPU_TORCH_DEVICE`` names
(``cpu`` runs the kernels' plain versions), else the first CUDA device.

Usage: python -m nnc_tpu_torch.tools.demo_synthetic [--hw 64] [--iters 100]
           [--qp -20] [--full-mlp]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--hw", type=int, default=64, help="image side")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--qp", type=int, default=-20)
    ap.add_argument("--out", type=str, default="./demo_run")
    ap.add_argument("--i-save", type=int, default=0)
    ap.add_argument("--full-mlp", action="store_true",
                    help="use the flagship 8x256 MLP (default: 8x64)")
    ap.add_argument("--occupancy-tuning", action="store_true",
                    help="LSA tunes on grid-selected samples, and test "
                         "views render through the grid (one grid build "
                         "per tuning run)")
    args = ap.parse_args(argv)

    import nnc_tpu_torch
    from nnc_tpu_torch.data import synthetic
    from nnc_tpu_torch.models import nerf
    from nnc_tpu_torch.render import renderer
    from nnc_tpu_torch.train.presets import create_nerf_model_executer
    from nnc_tpu_torch.utils import ckpt as cku
    from nnc_tpu_torch.utils.platform import device_from_env

    device = device_from_env()
    print(f"device: {device}")
    mlp = nerf.NeRFConfig() if args.full_mlp else nerf.NeRFConfig(W=64)
    rc = renderer.RenderConfig(mlp=mlp, n_samples=32, n_importance=32,
                               chunk=4096)
    t0 = time.time()
    scene, (tc, tf_) = synthetic.make_scene(n_images=6, H=args.hw,
                                            W=args.hw, mlp=mlp, rc=rc,
                                            seed=0, device=device)
    scene["n_importance"] = 32
    print(f"scene built in {time.time()-t0:.1f}s")

    sd = {}
    sd.update(nerf.params_to_state_dict(tc, "model."))
    sd.update(nerf.params_to_state_dict(tf_, "model_fine."))
    os.makedirs(args.out, exist_ok=True)
    tar = os.path.join(args.out, "teacher_200000.tar")
    cku.wrapper_dict_to_nerf_tar(sd, tar)

    wrapper, _ = cku.nerf_tar_to_wrapper_dict(tar)
    paths = cku.create_save_path(args.out, "teacher", args.qp, True,
                                 args.epochs, 1e-3, "NeRF", "synthetic",
                                 args.iters, 0.1)

    ex = create_nerf_model_executer(
        scene=scene, device=device, mlp_config=mlp, learning_rate=1e-3,
        epochs=args.epochs, learning_rate_decay=0.1, n_iters=args.iters,
        i_save=args.i_save, use_fused_mlp=True, verbose=True)
    if args.occupancy_tuning:
        ex.rc = dataclasses.replace(ex.rc, use_occupancy_tuning=True,
                                    use_occupancy_renders=True)

    t0 = time.time()
    nnc_tpu_torch.compress_model(wrapper, bitstream_path=paths["bitstream"],
                                 qp=args.qp, lsa=True, model_executer=ex,
                                 scene=scene, mlp_config=mlp, verbose=True,
                                 device=device)
    t_comp = time.time() - t0
    nnc_tpu_torch.decompress_model(paths["bitstream"],
                                   model_path=paths["reconstructed"])
    cku.convert_nerfwrapper_to_nerf_ckpt(
        paths["reconstructed"],
        cku.change_extension_to_tar(paths["reconstructed"]))

    rec = nnc_tpu_torch.decompress(paths["bitstream"], verbose=False)
    psnr_lsa = ex.test_model(rec)
    # baseline: no LSA at same qp
    bs2 = os.path.join(args.out, "nolsa.nnc")
    nnc_tpu_torch.compress_model(wrapper, bitstream_path=bs2, qp=args.qp,
                                 lsa=False, verbose=False, device=device)
    psnr_plain = ex.test_model(nnc_tpu_torch.decompress(bs2, verbose=False))
    psnr_teacher = ex.test_model(wrapper)

    raw = sum(np.asarray(v).nbytes for v in wrapper.values())
    result = {
        "raw_bytes": int(raw),
        "bitstream_bytes": os.path.getsize(paths["bitstream"]),
        "compress_seconds": round(t_comp, 1),
        "psnr_teacher": round(psnr_teacher, 3),
        "psnr_quantized": round(psnr_plain, 3),
        "psnr_quantized_lsa": round(psnr_lsa, 3),
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
