"""Per-dataset scene construction + render presets.

Counterpart of ``nnc_tpu/train/presets.py`` with the reference's hardcoded
hyperparameters (reference: framework/applications/utils/train_nerf.py:37-70):
  blender (lego): no_batching, use_viewdirs, white_bkgd, N_samples=64,
    N_importance=128, N_rand=1024, half_res, near 2 / far 6
  llff (fern): factor=8, llffhold=8, N_rand=1024, N_samples=64,
    N_importance=64, raw_noise_std=1.0, NDC near 0 / far 1
  deepvoxels (the scene in $NNC_TPU_DV_SHAPE, default greek): near / far
    1 around the mean camera radius; LINEMOD: the split files' near / far
The dataset loaders are the port's own ``data.blender``, ``data.llff``,
``data.deepvoxels`` and ``data.linemod``.

A config file with ``model = mipnerf`` (``nnc_tpu_torch/configs/
mip_lego.txt``) makes a mip-NeRF scene: its mip-NeRF keys go to
``scene["mip"]``, its rays leave through the pixels' centres (the principal
point half a pixel up and left, as mip-NeRF's loader casts them), and the
executer renders and tunes it through ``render/mipnerf.py``. One with
``model = mipnerf360`` (``nnc_tpu_torch/configs/mip360_garden.txt``) makes a
mip-NeRF 360 scene: its keys go to ``scene["mip360"]``, its rays leave
through the pixels' centres, NDC is off where the file says ``no_ndc``
(forward-facing NDC scenes are refused), its rays are batched from the pool
of every training view's rays, and the executer renders and tunes it
through ``render/mipnerf360.py``.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..framework.executer import NeRFModelExecuter
from ..models import nerf
from ..render import mipnerf, mipnerf360, renderer

DEFAULT_DATA_ROOT = os.environ.get(
    "NNC_TPU_DATA_ROOT",
    os.path.join(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))), "data"))

DATASET_DIRS = {
    "blender": "nerf_synthetic/lego",
    "llff": "nerf_llff_data/fern",
}


def _intrinsics(H, W, focal):
    return np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]],
                    np.float32)


def load_scene(dataset_type: str, data_dir: str = None, half_res=True,
               testskip=8, factor=8, llffhold=8, spherify=False):
    """Build the scene dict consumed by NeRFModelExecuter / RayBatcher."""
    if data_dir is None:
        data_dir = os.path.join(DEFAULT_DATA_ROOT,
                                DATASET_DIRS.get(dataset_type, ""))
    if dataset_type == "blender":
        from ..data.blender import load_blender_data
        images, poses, render_poses, hwf, i_split = load_blender_data(
            data_dir, half_res=half_res, testskip=testskip)
        i_train, _i_val, i_test = i_split
        # white background composite (reference run_nerf.py:537-541)
        images = images[..., :3] * images[..., -1:] + (1.0 - images[..., -1:])
        H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
        return {
            "images": images.astype(np.float32),
            "poses": poses[:, :3, :4],
            "render_poses": render_poses[:, :3, :4],
            "K": _intrinsics(H, W, focal), "H": H, "W": W,
            "i_train": i_train, "i_test": i_test,
            "near": 2.0, "far": 6.0,
            "white_bkgd": True, "ndc": False,
            "batching_mode": "image",
            "raw_noise_std": 0.0,
            "n_importance": 128,
            "dataset_type": "blender",
        }
    if dataset_type == "llff":
        from ..data.llff import load_llff_data
        images, poses, bds, render_poses, i_test = load_llff_data(
            data_dir, factor=factor, recenter=True, bd_factor=0.75,
            spherify=spherify)
        hwf = poses[0, :3, -1]
        poses = poses[:, :3, :4]
        if llffhold > 0:
            i_test = np.arange(images.shape[0])[::llffhold]
        else:
            i_test = np.array([i_test])
        i_train = np.array([i for i in np.arange(images.shape[0])
                            if i not in i_test])
        H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
        return {
            "images": images.astype(np.float32),
            "poses": poses,
            "render_poses": render_poses[:, :3, :4],
            "K": _intrinsics(H, W, focal), "H": H, "W": W,
            "i_train": i_train, "i_test": i_test,
            "near": 0.0, "far": 1.0,
            "white_bkgd": False, "ndc": True,
            "batching_mode": "pool",
            "raw_noise_std": 1.0,
            "n_importance": 64,
            "dataset_type": "llff",
        }
    if dataset_type == "deepvoxels":
        from ..data.deepvoxels import load_dv_data
        images, poses, render_poses, hwf, i_split = load_dv_data(
            scene=os.environ.get("NNC_TPU_DV_SHAPE", "greek"),
            basedir=data_dir, testskip=testskip)
        i_train, _i_val, i_test = i_split
        hemi_r = float(np.mean(np.linalg.norm(poses[:, :3, -1], axis=-1)))
        H, W, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
        return {
            "images": images[..., :3].astype(np.float32),
            "poses": poses[:, :3, :4],
            "render_poses": render_poses[:, :3, :4],
            "K": _intrinsics(H, W, focal), "H": H, "W": W,
            "i_train": i_train, "i_test": i_test,
            "near": hemi_r - 1.0, "far": hemi_r + 1.0,
            "white_bkgd": False, "ndc": False,
            "batching_mode": "image",
            "raw_noise_std": 0.0,
            "n_importance": 128,
            "dataset_type": "deepvoxels",
        }
    if dataset_type == "LINEMOD":
        from ..data.linemod import load_LINEMOD_data
        images, poses, render_poses, hwf, K, i_split, near, far = \
            load_LINEMOD_data(data_dir, half_res=half_res, testskip=testskip)
        i_train, _i_val, i_test = i_split
        H, W = int(hwf[0]), int(hwf[1])
        return {
            "images": images[..., :3].astype(np.float32),
            "poses": poses[:, :3, :4],
            "render_poses": np.asarray(render_poses)[:, :3, :4],
            "K": np.asarray(K, np.float32), "H": H, "W": W,
            "i_train": i_train, "i_test": i_test,
            "near": float(near), "far": float(far),
            "white_bkgd": False, "ndc": False,
            "batching_mode": "image",
            "raw_noise_std": 0.0,
            "n_importance": 128,
            "dataset_type": "LINEMOD",
        }
    raise ValueError(f"dataset_type '{dataset_type}' is not implemented "
                     "(expected 'blender', 'llff', 'deepvoxels', 'LINEMOD', "
                     "or pass scene=...)")


def load_scene_from_config(config_path: str, data_dir: str = None):
    """Build a scene from a nerf-pytorch style configs/*.txt file.
    Returns (scene, leftover overrides e.g. n_samples/n_rand)."""
    from ..utils.config_txt import load_config, scene_overrides
    ov = scene_overrides(load_config(config_path))
    dataset_type = ov.pop("dataset_type")
    data_dir = data_dir or ov.pop("data_dir", None)
    scene_kwargs = {k: ov.pop(k) for k in
                    ("half_res", "testskip", "factor", "llffhold",
                     "spherify") if k in ov}
    scene = load_scene(dataset_type, data_dir, **scene_kwargs)
    for k in ("white_bkgd", "raw_noise_std", "n_importance", "near", "far"):
        if k in ov:
            scene[k] = ov.pop(k)
    model = ov.pop("model", "nerf")
    if model == "mipnerf":
        scene["mip"] = ov.pop("mip", {})
        scene["K"] = pixel_centres(scene["K"])
    if model == "mipnerf360":
        scene["mip360"] = ov.pop("mip360", {})
        scene["K"] = pixel_centres(scene["K"])
        if ov.pop("no_ndc", False):
            scene["ndc"] = False
        scene.update(batching_mode="pool", raw_noise_std=0.0,
                     white_bkgd=False)
    return scene, ov


def pixel_centres(K):
    """K with the principal point half a pixel up and left, so that rays
    leave through the pixels' centres ((x - W / 2 + 0.5) / f, mip-NeRF's
    datasets.py)."""
    K = np.array(K, np.float32)
    K[0, 2] -= 0.5
    K[1, 2] -= 0.5
    return K


def make_render_config(scene, mlp_config=None, chunk=1024 * 32,
                       use_fused_mlp=False, n_samples=64,
                       n_importance=None):
    mlp_config = mlp_config or nerf.NeRFConfig()
    return renderer.RenderConfig(
        mlp=mlp_config,
        n_samples=n_samples,
        n_importance=int(scene.get("n_importance", 128)
                         if n_importance is None else n_importance),
        perturb=True,
        white_bkgd=bool(scene.get("white_bkgd", False)),
        raw_noise_std=float(scene.get("raw_noise_std", 0.0)),
        lindisp=False,
        chunk=chunk,
        use_fused_mlp=use_fused_mlp,
        # deterministic renders take K-B2 (fused compositing, early
        # termination, empty-ray culling) or K-B3; training renders take
        # the fused train pair K-B1
        use_fused_compositing=use_fused_mlp,
        use_fused_train=use_fused_mlp,
    )


def create_nerf_model_executer(dataset_type="blender", dataset_path=None,
                               scene=None, *, device, learning_rate=1e-4,
                               epochs=2, learning_rate_decay=0.1,
                               n_iters=50000, i_save=10000, mlp_config=None,
                               use_fused_mlp=False, verbose=True,
                               render_factor=0, precrop_iters=0,
                               precrop_frac=0.5, n_rand=1024, n_samples=64,
                               n_importance=None, mesh=None):
    """Build the NeRF executer (the codec's model_executer) on ``device``;
    with ``mesh`` (``parallel.Mesh``) its tuning steps run data-parallel.
    (reference: framework/pytorch_model/__init__.py:924-959)"""
    if scene is None:
        scene = load_scene(dataset_type, dataset_path)
    if "mip360" in scene:
        if mlp_config is not None and \
                getattr(mlp_config, "compute_dtype", None) == torch.bfloat16:
            raise ValueError("mip-NeRF 360 runs in float32 only: no bf16 "
                             "body")
        rc = mipnerf360.make_render_config(scene)
    elif "mip" in scene:
        rc = mipnerf.make_render_config(scene, mlp_config,
                                        use_fused_mlp=use_fused_mlp)
    else:
        rc = make_render_config(scene, mlp_config,
                                use_fused_mlp=use_fused_mlp,
                                n_samples=n_samples,
                                n_importance=n_importance)
    return NeRFModelExecuter(
        scene, rc, device=device, learning_rate=learning_rate,
        epochs=epochs, learning_rate_decay=learning_rate_decay,
        n_iters=n_iters, i_save=i_save, verbose=verbose, n_rand=n_rand,
        render_factor=render_factor, precrop_iters=precrop_iters,
        precrop_frac=precrop_frac, mesh=mesh)
