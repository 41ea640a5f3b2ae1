"""LINEMOD dataset loader (blender-style transforms json with intrinsics +
near/far per split). (reference: framework/nerf_model/load_LINEMOD.py:42-100.)
Counterpart of ``nnc_tpu/data/linemod.py``, the same code.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .blender import pose_spherical


def load_LINEMOD_data(basedir, half_res=False, testskip=1):
    import imageio.v2 as imageio

    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        meta = metas[s]
        skip = 1 if s == "train" or testskip == 0 else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            imgs.append(imageio.imread(frame["file_path"]))
            poses.append(np.array(frame["transform_matrix"]))
        imgs = (np.array(imgs) / 255.0).astype(np.float32)
        poses = np.array(poses).astype(np.float32)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(poses)

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    H, W = imgs[0].shape[:2]
    K = metas["test"]["frames"][0]["intrinsic_matrix"]
    focal = float(K[0][0])

    render_poses = np.stack(
        [pose_spherical(angle, -30.0, 4.0)
         for angle in np.linspace(-180, 180, 40 + 1)[:-1]], 0)

    if half_res:
        import cv2
        H, W = H // 2, W // 2
        focal = focal / 2.0
        imgs_half = np.zeros((imgs.shape[0], H, W, 3), np.float32)
        for i, img in enumerate(imgs):
            imgs_half[i] = cv2.resize(img[..., :3], (W, H),
                                      interpolation=cv2.INTER_AREA)
        imgs = imgs_half

    near = np.floor(min(metas["train"]["near"], metas["test"]["near"]))
    far = np.ceil(max(metas["train"]["far"], metas["test"]["far"]))
    return imgs, poses, render_poses, [H, W, focal], K, i_split, near, far
