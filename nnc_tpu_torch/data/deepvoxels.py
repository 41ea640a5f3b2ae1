"""DeepVoxels dataset loader.

Counterpart of ``nnc_tpu/data/deepvoxels.py``, the same code but for the
last line of ``intrinsics.txt``, read without a try (the port keeps
exception handling away from its modules).

Format: ``{basedir}/{split}/{scene}/`` with ``intrinsics.txt`` (focal,
principal point, near plane, scale, image size), per-view ``pose/*.txt``
(4x4 world matrices) and ``rgb/*.png``.
(reference: framework/nerf_model/load_deepvoxels.py:6-110.)
"""
from __future__ import annotations

import os

import numpy as np


def parse_intrinsics(filepath, trgt_sidelength, invert_y=False):
    with open(filepath, "r") as f:
        fval, cx, cy = list(map(float, f.readline().split()))[:3]
        grid_barycenter = np.array(list(map(float, f.readline().split())))
        near_plane = float(f.readline())
        scale = float(f.readline())
        height, width = map(float, f.readline().split())
        # an optional last line: 1 for world-to-camera poses (the
        # reference takes anything that is no integer as 0)
        line = f.readline().strip()
        world2cam_poses = int(line) if line.lstrip("+-").isdigit() else 0
    cx = cx / width * trgt_sidelength
    cy = cy / height * trgt_sidelength
    fval = trgt_sidelength / height * fval
    fy = -fval if invert_y else fval
    full_intrinsic = np.array([[fval, 0.0, cx, 0.0],
                               [0.0, fy, cy, 0.0],
                               [0.0, 0.0, 1.0, 0.0],
                               [0.0, 0.0, 0.0, 1.0]])
    return (full_intrinsic, grid_barycenter, scale, near_plane,
            bool(world2cam_poses))


def _load_pose(filename):
    nums = open(filename).read().split()
    return np.array([float(x) for x in nums]).reshape([4, 4]).astype(
        np.float32)


def _dir2poses(posedir):
    poses = np.stack(
        [_load_pose(os.path.join(posedir, f))
         for f in sorted(os.listdir(posedir)) if f.endswith("txt")], 0)
    transf = np.array([[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0],
                       [0, 0, 0, 1.0]])
    return (poses @ transf)[:, :3, :4].astype(np.float32)


def _load_imgs(imgdir, skip=1):
    import imageio.v2 as imageio
    files = [f for f in sorted(os.listdir(imgdir)) if f.endswith("png")]
    return np.stack([imageio.imread(os.path.join(imgdir, f)) / 255.0
                     for f in files[::skip]], 0).astype(np.float32)


def load_dv_data(scene="cube", basedir="/data/deepvoxels", testskip=8):
    H = W = 512
    base = os.path.join(basedir, "train", scene)
    full_intrinsic, _bary, _scale, _near, _w2c = parse_intrinsics(
        os.path.join(base, "intrinsics.txt"), H)
    focal = full_intrinsic[0, 0]

    poses = _dir2poses(os.path.join(base, "pose"))
    testposes = _dir2poses(os.path.join(basedir, "test", scene,
                                        "pose"))[::testskip]
    valposes = _dir2poses(os.path.join(basedir, "validation", scene,
                                       "pose"))[::testskip]

    imgs = _load_imgs(os.path.join(base, "rgb"))
    testimgs = _load_imgs(os.path.join(basedir, "test", scene, "rgb"),
                          testskip)
    valimgs = _load_imgs(os.path.join(basedir, "validation", scene, "rgb"),
                         testskip)

    all_imgs = [imgs, valimgs, testimgs]
    counts = np.cumsum([0] + [x.shape[0] for x in all_imgs])
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate([poses, valposes, testposes], 0)
    return imgs, poses, testposes, [H, W, focal], i_split
