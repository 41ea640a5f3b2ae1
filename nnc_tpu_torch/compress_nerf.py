"""Command line: compress a vanilla-NeRF checkpoint with (optionally) LSA,
on an NVIDIA GPU.

    python -m nnc_tpu_torch.compress_nerf --ckpt_path lego_200000.tar ...

The counterpart of ``compress_nerf.py``, with its flags, defaults and help,
and its pipeline (reference: compress_nerf.py:5-63):
  1. load nerf-pytorch .tar checkpoint -> flat NeRFWrapper state dict
  2. create timestamped save paths (bitstream/, reconstructed/)
  3. compress (NNR bitstream; LSA tunes scales by rendering on the GPU)
  4. decompress -> reconstructed .pt
  5. convert back to a standard nerf-pytorch .tar
The device is the one the ``NNC_TPU_TORCH_DEVICE`` environment variable
names (``cpu`` runs the plain versions of the kernels), else the first CUDA
device, as the root CLI reads ``JAX_PLATFORMS``. ``--occupancy_renders`` /
``--occupancy_tuning`` run the frame renders / the LSA loss through an
occupancy grid (``render/occupancy.py``) on the flagship architecture.
``--config nnc_tpu_torch/configs/mip_lego.txt`` compresses a mip-NeRF
checkpoint (one MLP, ``model.*``) of the Blender lego scene, its LSA on
mip-NeRF's two-level loss through ``render/mipnerf.py``; there the config
file's ``N_rand`` (4,096) takes the place of ``--N_rand``'s default.
``--config nnc_tpu_torch/configs/mip360_garden.txt`` compresses a mip-NeRF
360 checkpoint (the proposal MLP as ``model.*``, the NeRF MLP as
``model_fine.*``) of an unbounded LLFF-layout capture, its LSA on mip-NeRF
360's three-term loss through ``render/mipnerf360.py`` at the file's
``N_rand`` (16,384).
"""
import argparse

import nnc_tpu_torch
from nnc_tpu_torch.train.presets import load_scene_from_config
from nnc_tpu_torch.utils import ckpt as utils
from nnc_tpu_torch.utils.platform import device_from_env


def main(args):
    device = device_from_env()
    wrapper_dict, _gstep = utils.nerf_tar_to_wrapper_dict(args.ckpt_path)

    scene, extra = None, {}
    if args.config:
        scene, extra = load_scene_from_config(
            args.config, None if args.dataset_path in ("~", "")
            else args.dataset_path)
    n_rand = args.N_rand
    if scene is not None and ("mip" in scene or "mip360" in scene) and \
            "n_rand" in extra and \
            n_rand == build_parser().get_default("N_rand"):
        n_rand = int(extra["n_rand"])

    path_dict = utils.create_save_path(
        ckpt_nickname=args.ckpt_nickname,
        base_path_to_save=args.base_path_to_save,
        qp=args.qp,
        lsa=args.lsa,
        epochs=args.epochs,
        learning_rate=args.learning_rate,
        task_type=args.task_type,
        dataset_type=args.dataset_type,
        N_iters=args.N_iters,
        learning_rate_decay=args.learning_rate_decay)

    nnc_tpu_torch.compress_model(
        model_path_or_object=wrapper_dict,
        bitstream_path=path_dict["bitstream"],
        qp=args.qp,
        epochs=args.epochs,
        learning_rate=args.learning_rate,
        lsa=args.lsa,
        dataset_path=(None if args.dataset_path in ("~", "")
                      else args.dataset_path),
        task_type=args.task_type,
        dataset_type=args.dataset_type,
        N_iters=args.N_iters,
        learning_rate_decay=args.learning_rate_decay,
        i_save=args.i_save,
        scene=scene,
        use_fused_mlp=args.use_fused_mlp,
        occupancy_renders=args.occupancy_renders,
        occupancy_tuning=args.occupancy_tuning,
        ioq=args.ioq,
        ioq_codebook=args.ioq_codebook,
        num_workers=args.num_workers,
        render_factor=args.render_factor,
        precrop_iters=args.precrop_iters,
        precrop_frac=args.precrop_frac,
        N_rand=n_rand,
        n_samples=args.n_samples,
        n_importance=args.n_importance,
        device=device)

    nnc_tpu_torch.decompress_model(path_dict["bitstream"],
                                   model_path=path_dict["reconstructed"])

    utils.convert_nerfwrapper_to_nerf_ckpt(
        nerfwrapper_path=path_dict["reconstructed"],
        ckpt_path=utils.change_extension_to_tar(path_dict["reconstructed"]))


def _flag(s):
    return s.lower() in ("1", "true", "yes")


def build_parser():
    parser = argparse.ArgumentParser(description="NeRF Processing Script")
    parser.add_argument("--ckpt_path", type=str, required=True,
                        help="Path to checkpoint file (.tar).")
    parser.add_argument("--ckpt_nickname", default="lego_200K", type=str)
    parser.add_argument("--base_path_to_save", type=str, default="./runs")
    parser.add_argument("--qp", type=int, default=-15,
                        help="Quantization Parameter.")
    parser.add_argument("--lsa", type=_flag, default=True)
    parser.add_argument("--epochs", type=int, default=2)
    parser.add_argument("--learning_rate", type=float, default=1e-4)
    parser.add_argument("--task_type", type=str, default="NeRF",
                        choices=["NeRF", "Classification"])
    parser.add_argument("--dataset_type", type=str, default="blender",
                        choices=["blender", "llff"])
    parser.add_argument("--N_iters", type=int, default=20000)
    parser.add_argument("--learning_rate_decay", type=float, default=0.5)
    parser.add_argument("--i_save", type=int, default=10000)
    parser.add_argument("--dataset_path", type=str, default="~")
    parser.add_argument("--config", type=str, default=None,
                        help="Optional configs/*.txt scene config.")
    parser.add_argument("--use_fused_mlp", type=_flag, default=True,
                        help="Use the Pallas fused MLP for renders.")
    parser.add_argument("--occupancy_renders", type=_flag, default=False,
                        help="Route i_save/test full-frame renders through "
                             "the occupancy-grid fast mode (lossy, ~4x).")
    parser.add_argument("--occupancy_tuning", type=_flag, default=False,
                        help="LSA tuning integrates grid-selected samples "
                             "instead of the dense hierarchical sweep "
                             "(~3x faster steps, slightly lossy objective).")
    parser.add_argument("--ioq", type=_flag, default=False,
                        help="Inference-optimized per-tensor QP search "
                             "(RD win: +7 dB at -21%% bytes vs flat "
                             "qp=-20 on the synthetic teacher; see "
                             "BASELINE.md).")
    parser.add_argument("--ioq_codebook", type=_flag, default=False,
                        help="With --ioq: also arbitrate uniform-vs-"
                             "codebook per tensor with the render probe "
                             "(the tensor-MSE mode-2 choice under-values "
                             "codebooks at high rate; BASELINE.md r4/r5).")
    parser.add_argument("--num_workers", type=int, default=0,
                        help="Host threads for parallel NDU encode/decode.")
    parser.add_argument("--render_factor", type=int, default=0,
                        help="Downsample spiral/preview renders by this "
                             "divisor (0 = full res; ref run_nerf.py:161).")
    parser.add_argument("--precrop_iters", type=int, default=0,
                        help="Sample from the image center crop for the "
                             "first N batches (ref run_nerf.py:715-725).")
    parser.add_argument("--precrop_frac", type=float, default=0.5)
    parser.add_argument("--N_rand", type=int, default=1024,
                        help="Rays per LSA tuning batch.")
    parser.add_argument("--n_samples", type=int, default=64,
                        help="Coarse samples per ray.")
    parser.add_argument("--n_importance", type=int, default=None,
                        help="Fine samples per ray (default: scene preset).")
    return parser


if __name__ == "__main__":
    args = build_parser().parse_args()
    print("\n############## PROVIDED ARGUMENTS ################")
    for arg, value in vars(args).items():
        print(f"{arg}: {value}")
    print("##################################################\n")
    main(args)
