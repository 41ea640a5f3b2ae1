"""Host-side ray batching (numpy), counterpart of ``nnc_tpu/data/rays.py``.

Two sampling modes mirroring the reference hot loop
(reference: run_nerf.py:654-735):
  * "image" (no_batching): pick a random training image, then N_rand random
    pixels from it (blender path).
  * "pool" (use_batching): precompute rays for all training images, shuffle
    the flat pool, walk it in N_rand slices, reshuffle per epoch (llff path).
The draw sequence for a seed is the reference's, draw for draw.
"""
from __future__ import annotations

import numpy as np

from ..render.rays import get_rays_np


class RayBatcher:
    def __init__(self, images, poses, K, i_train, n_rand: int,
                 mode: str = "image", seed: int = 0,
                 precrop_iters: int = 0, precrop_frac: float = 0.5):
        """images: (N, H, W, 3) float32; poses: (N, 3|4, 4); K: (3, 3).
        The first ``precrop_iters`` "image" batches sample only the center
        crop of fraction ``precrop_frac`` (reference: run_nerf.py:715-725)."""
        if mode not in ("image", "pool"):
            raise ValueError(f"mode must be 'image' or 'pool': {mode!r}")
        self.images = np.asarray(images, np.float32)
        self.poses = np.asarray(poses, np.float32)
        self.K = np.asarray(K, np.float32)
        self.i_train = np.asarray(i_train)
        self.n_rand = min(n_rand,
                          self.images.shape[1] * self.images.shape[2])
        self.mode = mode
        self.rng = np.random.default_rng(seed)
        self.H, self.W = self.images.shape[1:3]
        self.precrop_iters = int(precrop_iters)
        self.precrop_frac = float(precrop_frac)
        self._step = 0

        if mode == "pool":
            rays = [np.stack(get_rays_np(self.H, self.W, self.K,
                                         self.poses[i, :3, :4]), 0)
                    for i in self.i_train]
            rays = np.stack(rays, 0)  # (Nt, 2, H, W, 3)
            rays_rgb = np.concatenate(
                [rays, self.images[self.i_train][:, None]], 1)
            self.pool = rays_rgb.transpose(0, 2, 3, 1, 4).reshape(-1, 3, 3)
            self.rng.shuffle(self.pool)
            self.i_batch = 0

    def next_batch(self):
        """Returns (rays_o, rays_d, target), each (n_rand, 3) float32."""
        if self.mode == "pool":
            if self.i_batch + self.n_rand > self.pool.shape[0]:
                self.rng.shuffle(self.pool)
                self.i_batch = 0
            batch = self.pool[self.i_batch:self.i_batch + self.n_rand]
            self.i_batch += self.n_rand
            return batch[:, 0], batch[:, 1], batch[:, 2]

        img_i = self.rng.choice(self.i_train)
        target = self.images[img_i]
        rays_o, rays_d = get_rays_np(self.H, self.W, self.K,
                                     self.poses[img_i, :3, :4])
        if self._step < self.precrop_iters:
            dH = int(self.H // 2 * self.precrop_frac)
            dW = int(self.W // 2 * self.precrop_frac)
            n = min(self.n_rand, 4 * dH * dW)
            sel = self.rng.choice(2 * dH * 2 * dW, size=n, replace=False)
            ys = self.H // 2 - dH + sel // (2 * dW)
            xs = self.W // 2 - dW + sel % (2 * dW)
        else:
            sel = self.rng.choice(self.H * self.W, size=self.n_rand,
                                  replace=False)
            ys, xs = sel // self.W, sel % self.W
        self._step += 1
        return (rays_o[ys, xs].astype(np.float32),
                rays_d[ys, xs].astype(np.float32),
                target[ys, xs].astype(np.float32))
