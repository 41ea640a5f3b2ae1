"""Blender (nerf_synthetic) dataset loader.

Format: ``transforms_{train,val,test}.json`` with ``camera_angle_x`` and
frames of ``{file_path, transform_matrix}``; RGBA PNGs. half_res downsamples
2x. 40 spherical render poses are synthesized for video paths.
(reference: framework/nerf_model/load_blender.py:43-90.)
"""
from __future__ import annotations

import json
import os

import numpy as np


def _trans_t(t):
    return np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, t], [0, 0, 0, 1]],
                    np.float32)


def _rot_phi(phi):
    return np.array([[1, 0, 0, 0],
                     [0, np.cos(phi), -np.sin(phi), 0],
                     [0, np.sin(phi), np.cos(phi), 0],
                     [0, 0, 0, 1]], np.float32)


def _rot_theta(th):
    return np.array([[np.cos(th), 0, -np.sin(th), 0],
                     [0, 1, 0, 0],
                     [np.sin(th), 0, np.cos(th), 0],
                     [0, 0, 0, 1]], np.float32)


def pose_spherical(theta, phi, radius):
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta / 180.0 * np.pi) @ c2w
    c2w = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                   np.float32) @ c2w
    return c2w


def load_blender_data(basedir, half_res=False, testskip=1):
    """Returns (images RGBA float[0,1], poses, render_poses, [H, W, focal],
    i_split)."""
    import imageio.v2 as imageio

    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as f:
            metas[s] = json.load(f)

    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        meta = metas[s]
        skip = 1 if s == "train" or testskip == 0 else testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            fname = os.path.join(basedir, frame["file_path"] + ".png")
            imgs.append(imageio.imread(fname))
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
    camera_angle_x = float(metas["train"]["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)

    render_poses = np.stack(
        [pose_spherical(angle, -30.0, 4.0)
         for angle in np.linspace(-180, 180, 40 + 1)[:-1]], 0)

    if half_res:
        import cv2
        H = H // 2
        W = W // 2
        focal = focal / 2.0
        imgs_half = np.zeros((imgs.shape[0], H, W, imgs.shape[-1]),
                             np.float32)
        for i, img in enumerate(imgs):
            imgs_half[i] = cv2.resize(img, (W, H),
                                      interpolation=cv2.INTER_AREA)
        imgs = imgs_half

    return imgs, poses, render_poses, [H, W, focal], i_split
