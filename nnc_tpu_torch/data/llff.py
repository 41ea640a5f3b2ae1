"""LLFF (forward-facing) dataset loader.

Format: ``poses_bounds.npy`` (N, 17): 3x5 pose matrix ([R|t|hwf]) + 2 depth
bounds per image; images under ``images/`` (optionally pre-minified into
``images_{factor}/``, generated here with cv2 instead of imagemagick).
Includes pose recentering, bd rescaling, spiral/spherical render paths.
(reference: framework/nerf_model/load_llff.py:7-314.)
"""
from __future__ import annotations

import os

import numpy as np


def _minify(basedir, factors=(), resolutions=()):
    """Create images_{f}/ downsampled copies if missing (cv2-based)."""
    import cv2
    import imageio.v2 as imageio

    needtoload = False
    for r in factors:
        if not os.path.exists(os.path.join(basedir, f"images_{r}")):
            needtoload = True
    for r in resolutions:
        if not os.path.exists(os.path.join(basedir, f"images_{r[1]}x{r[0]}")):
            needtoload = True
    if not needtoload:
        return

    imgdir = os.path.join(basedir, "images")
    imgs = sorted(f for f in os.listdir(imgdir)
                  if f.lower().endswith(("jpg", "jpeg", "png")))
    for r in list(factors) + list(resolutions):
        if isinstance(r, int):
            name = f"images_{r}"
        else:
            name = f"images_{r[1]}x{r[0]}"
        outdir = os.path.join(basedir, name)
        if os.path.exists(outdir):
            continue
        os.makedirs(outdir)
        for f in imgs:
            img = imageio.imread(os.path.join(imgdir, f))
            if isinstance(r, int):
                h, w = img.shape[0] // r, img.shape[1] // r
            else:
                h, w = r[0], r[1]
            out = cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)
            out_name = os.path.splitext(f)[0] + ".png"
            imageio.imwrite(os.path.join(outdir, out_name), out)


def _load_data(basedir, factor=None):
    import imageio.v2 as imageio

    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    sfx = ""
    if factor is not None and factor != 1:
        sfx = f"_{factor}"
        _minify(basedir, factors=[factor])
    else:
        factor = 1

    imgdir = os.path.join(basedir, "images" + sfx)
    if not os.path.exists(imgdir):
        raise FileNotFoundError(imgdir)
    imgfiles = sorted(
        os.path.join(imgdir, f) for f in os.listdir(imgdir)
        if f.lower().endswith(("jpg", "jpeg", "png")))
    assert poses.shape[-1] == len(imgfiles), \
        f"{len(imgfiles)} images vs {poses.shape[-1]} poses"

    sh = imageio.imread(imgfiles[0]).shape
    poses[:2, 4, :] = np.array(sh[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] / factor

    imgs = [imageio.imread(f)[..., :3] / 255.0 for f in imgfiles]
    imgs = np.stack(imgs, -1).astype(np.float32)
    return poses, bds, imgs


def normalize(x):
    return x / np.linalg.norm(x)


def viewmatrix(z, up, pos):
    vec2 = normalize(z)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def poses_avg(poses):
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([viewmatrix(vec2, up, center), hwf], 1)


def recenter_poses(poses):
    poses_ = poses + 0
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], -2)
    bottom = np.tile(np.reshape(bottom, [1, 1, 4]), [poses.shape[0], 1, 1])
    poses_h = np.concatenate([poses[:, :3, :4], bottom], -2)
    poses_h = np.linalg.inv(c2w) @ poses_h
    poses_[:, :3, :4] = poses_h[:, :3, :4]
    return poses_


def render_path_spiral(c2w, up, rads, focal, zdelta, zrate, rots, N):
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]:
        c = np.dot(c2w[:3, :4],
                   np.array([np.cos(theta), -np.sin(theta),
                             -np.sin(theta * zrate), 1.0]) * rads)
        z = normalize(c - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0])))
        render_poses.append(np.concatenate([viewmatrix(z, up, c), hwf], 1))
    return render_poses


def spherify_poses(poses, bds):
    p34_to_44 = lambda p: np.concatenate(
        [p, np.tile(np.reshape(np.eye(4)[-1, :], [1, 1, 4]),
                    [p.shape[0], 1, 1])], 1)
    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    def min_line_dist(rays_o, rays_d):
        A_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
        b_i = -A_i @ rays_o
        return np.squeeze(-np.linalg.inv(
            (np.transpose(A_i, [0, 2, 1]) @ A_i).mean(0)) @ b_i.mean(0))

    pt_mindist = min_line_dist(rays_o, rays_d)
    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = normalize(up)
    vec1 = normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = normalize(np.cross(vec0, vec1))
    pos = center
    c2w = np.stack([vec1, vec2, vec0, pos], 1)

    poses_reset = np.linalg.inv(p34_to_44(c2w[None])) @ \
        p34_to_44(poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(rad ** 2 - zh ** 2)
    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array([radcircle * np.cos(th),
                              radcircle * np.sin(th), zh])
        up = np.array([0, 0, -1.0])
        vec2 = normalize(camorigin)
        vec0 = normalize(np.cross(vec2, up))
        vec1 = normalize(np.cross(vec2, vec0))
        p = np.stack([vec0, vec1, vec2, camorigin], 1)
        new_poses.append(p)
    new_poses = np.stack(new_poses, 0)
    new_poses = np.concatenate(
        [new_poses, np.broadcast_to(poses[0, :3, -1:],
                                    new_poses[:, :3, -1:].shape)], -1)
    poses_reset = np.concatenate(
        [poses_reset[:, :3, :4],
         np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape)],
        -1)
    return poses_reset, new_poses, bds


def load_llff_data(basedir, factor=8, recenter=True, bd_factor=0.75,
                   spherify=False, path_zflat=False):
    """Returns (images, poses(+hwf), bds, render_poses, i_test).
    (reference: load_llff.py:241-314)"""
    poses, bds, imgs = _load_data(basedir, factor=factor)

    # correct rotation order: [down right back] -> [+X right, +Y up, +Z back]
    poses = np.concatenate(
        [poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    imgs = np.moveaxis(imgs, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds *= sc

    if recenter:
        poses = recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
    else:
        c2w = poses_avg(poses)
        up = normalize(poses[:, :3, 1].sum(0))
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        mean_dz = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)
        focal = mean_dz
        zdelta = close_depth * 0.2
        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0)
        c2w_path = c2w
        N_views, N_rots = 120, 2
        if path_zflat:
            zloc = -close_depth * 0.1
            c2w_path[:3, 3] = c2w_path[:3, 3] + zloc * c2w_path[:3, 2]
            rads[2] = 0.0
            N_rots, N_views = 1, N_views // 2
        render_poses = render_path_spiral(c2w_path, up, rads, focal, zdelta,
                                          zrate=0.5, rots=N_rots, N=N_views)
    render_poses = np.array(render_poses).astype(np.float32)

    c2w = poses_avg(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))
    return imgs, poses, bds, render_poses, i_test
