"""Synthetic scenes (no dataset download needed), rendered by the port.

Counterpart of ``nnc_tpu/data/synthetic.py``: a "teacher" NeRF renders
ground-truth images, giving a self-consistent scene any student model can be
compressed and tested against. Random teachers draw from a
``torch.Generator``, so their weights differ from the JAX package's for the
same seed; ``make_solid_mlp`` is deterministic and matches it exactly. A
random teacher can hold no density inside the cameras' view (at W=64, seed 0
every pixel renders 0), so ``make_scene`` / ``make_scene_ndc`` draw the next
pair from the same generator until every view holds density.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models import nerf
from ..render import renderer
from ..render.rays import get_rays_np, ndc_rays


def look_at_poses(n: int, radius: float = 4.0, seed: int = 0):
    """n camera-to-world poses on a sphere looking at the origin."""
    rng = np.random.default_rng(seed)
    poses = []
    for i in range(n):
        theta = 2 * np.pi * i / n
        phi = rng.uniform(-0.3, 0.3)
        eye = radius * np.array([np.cos(theta) * np.cos(phi),
                                 np.sin(theta) * np.cos(phi),
                                 np.sin(phi)], np.float32)
        forward = -eye / np.linalg.norm(eye)
        up = np.array([0.0, 0.0, 1.0], np.float32)
        right = np.cross(forward, up)
        right /= np.linalg.norm(right)
        true_up = np.cross(right, forward)
        c2w = np.stack([right, true_up, -forward], axis=-1)  # columns x,y,-z
        poses.append(np.concatenate([c2w, eye[:, None]], axis=-1))
    return np.stack(poses).astype(np.float32)


def _activate(model: nerf.NeRF, generator: torch.Generator) -> nerf.NeRF:
    """Give a random teacher visible density and color (random-init NeRFs
    output near-zero sigma): boost the alpha and rgb heads."""
    with torch.no_grad():
        model.alpha_linear.weight.mul_(40.0)
        model.alpha_linear.bias.add_(0.5)
        w = model.rgb_linear.weight
        w.mul_(20.0).add_(0.2 * torch.randn(w.shape, generator=generator)
                          .to(w.device))
    return model


def make_solid_mlp(config: Optional[nerf.NeRFConfig] = None,
                   radius: float = 1.5, density: float = 100.0,
                   rgb=(0.6, 0.2, -0.4), noise_std: float = 0.0,
                   generator: Optional[torch.Generator] = None,
                   device=None) -> nerf.NeRF:
    """Handcrafted NeRF whose density field is a solid octahedron
    (|x|_1 < radius) at the origin, empty elsewhere:
    sigma(x) = density * relu(radius - |x|_1), wired through relu(+-x_i)
    units and an identity chain; rgb is a constant from the head biases.
    ``noise_std`` > 0 adds N(0, noise_std^2) from ``generator`` to every
    weight, so that each tensor is dense."""
    config = config or nerf.NeRFConfig()
    if not (config.D == 8 and config.use_viewdirs and config.skips == (4,)):
        raise ValueError(f"make_solid_mlp needs the 8-layer viewdir "
                         f"architecture: {config}")
    model = nerf.NeRF(config)
    L = model.layers()
    with torch.no_grad():
        # torch layout (out, in); posenc channels 0:3 are raw x
        for j in range(3):
            L["pts_linears.0"].weight[j, j] = 1.0
            L["pts_linears.0"].weight[3 + j, j] = -1.0
        L["pts_linears.1"].weight[0, :6] = -1.0
        L["pts_linears.1"].bias[0] = radius
        for i in (2, 3, 4, 6, 7):
            L[f"pts_linears.{i}"].weight[0, 0] = 1.0
        L["pts_linears.5"].weight[0, config.input_ch] = 1.0  # after the skip
        L["alpha_linear"].weight[0, 0] = density
        L["rgb_linear"].bias.copy_(torch.tensor(rgb, dtype=torch.float32))
        if noise_std > 0:
            for layer in L.values():
                layer.weight.add_(noise_std * torch.randn(
                    layer.weight.shape, generator=generator))
    return model.to(device)


# a random teacher is redrawn while one of its views stops less than this
# share of the light (mean opacity): such a view renders (almost) black, so
# any student matches it and its PSNR says nothing
MIN_VIEW_OPACITY = 0.05
MAX_TEACHER_DRAWS = 16


def _random_teachers(mlp, generator):
    teacher_c = _activate(nerf.init_params(mlp, generator), generator)
    teacher_f = _activate(nerf.init_params(mlp, generator), generator)
    return teacher_c, teacher_f


def _teachers_and_images(mlp, seed, teachers, render_view, n_images,
                         device):
    """``teachers`` (moved to ``device``), or random ones from a generator
    seeded with ``seed``, redrawn until every view's mean opacity reaches
    MIN_VIEW_OPACITY; with the (n_images, H, W, 3) images they render.
    ``render_view(teacher_c, teacher_f, i)`` renders view i."""
    g = torch.Generator().manual_seed(seed)
    for _ in range(MAX_TEACHER_DRAWS):
        tc, tf = teachers or _random_teachers(mlp, g)
        tc, tf = tc.to(device), tf.to(device)
        outs = [render_view(tc, tf, i) for i in range(n_images)]
        opacity = min(float(o["acc_map"].mean()) for o in outs)
        if teachers or opacity >= MIN_VIEW_OPACITY:
            images = np.stack([o["rgb_map"].cpu().numpy() for o in outs])
            return (tc, tf), images.astype(np.float32)
    raise RuntimeError(f"no random teacher of {mlp} in {MAX_TEACHER_DRAWS} "
                       f"draws from seed {seed} holds density in every view")


def _scene_dict(images, poses, K, H, W, near, far, **extra):
    n_images = images.shape[0]
    scene = {
        "images": images, "poses": poses, "render_poses": poses, "K": K,
        "H": H, "W": W,
        "i_train": np.arange(max(1, n_images - 1)),
        "i_test": np.array([n_images - 1]),
        "near": near, "far": far,
        "white_bkgd": False, "ndc": False, "batching_mode": "image",
        "dataset_type": "synthetic",
    }
    scene.update(extra)
    return scene


def make_scene(n_images=4, H=16, W=16, mlp=None, rc=None, seed=0,
               near=2.0, far=6.0, *, teachers=None, focal=None,
               radius=4.0, device=None):
    """Inward-facing scene: cameras on a sphere of ``radius`` around the
    origin. Returns (scene dict, (teacher_c, teacher_f)). ``teachers``
    replaces the random teachers, which are redrawn until every view holds
    density (MIN_VIEW_OPACITY); ``rc`` renders the ground truth, and its
    ``white_bkgd`` is recorded in the scene."""
    mlp = mlp or nerf.NeRFConfig(W=32)
    rc = rc or renderer.RenderConfig(mlp=mlp, n_samples=16, n_importance=8,
                                     chunk=H * W)
    focal = 0.8 * W if focal is None else focal
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                 np.float32)
    poses = look_at_poses(n_images, radius=radius, seed=seed)

    def render_view(teacher_c, teacher_f, i):
        ro, rd = get_rays_np(H, W, K, poses[i, :3, :4])
        return renderer.render_image(teacher_c, teacher_f, ro, rd, near, far,
                                     rc, device=device)

    (teacher_c, teacher_f), images = _teachers_and_images(
        mlp, seed, teachers, render_view, n_images, device)
    scene = _scene_dict(images, poses, K, H, W, near, far,
                        white_bkgd=rc.white_bkgd)
    return scene, (teacher_c, teacher_f)


def make_scene_ndc(n_images=4, H=16, W=16, mlp=None, rc=None, seed=0, *,
                   teachers=None, device=None):
    """Forward-facing NDC scene (LLFF geometry): cameras near the origin
    looking down -z, rays warped by ``ndc_rays`` (near=1) and integrated
    over t in [0, 1], with pre-warp view directions."""
    mlp = mlp or nerf.NeRFConfig(W=32)
    rc = rc or renderer.RenderConfig(mlp=mlp, n_samples=16, n_importance=8,
                                     chunk=H * W)
    focal = 0.9 * W
    K = np.array([[focal, 0, W / 2], [0, focal, H / 2], [0, 0, 1]],
                 np.float32)
    rng = np.random.default_rng(seed)
    poses = []
    for _i in range(n_images):
        eye = np.array([rng.uniform(-0.25, 0.25), rng.uniform(-0.25, 0.25),
                        rng.uniform(-0.1, 0.1)], np.float32)
        poses.append(np.concatenate([np.eye(3, dtype=np.float32),
                                     eye[:, None]], axis=-1))
    poses = np.stack(poses).astype(np.float32)

    def render_view(teacher_c, teacher_f, i):
        ro, rd = get_rays_np(H, W, K, poses[i, :3, :4])
        vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
        ro_n, rd_n = ndc_rays(H, W, focal, 1.0, torch.as_tensor(ro),
                              torch.as_tensor(rd))
        return renderer.render_image(teacher_c, teacher_f, ro_n, rd_n, 0.0,
                                     1.0, rc, viewdirs=vd, device=device)

    (teacher_c, teacher_f), images = _teachers_and_images(
        mlp, seed, teachers, render_view, n_images, device)
    scene = _scene_dict(images, poses, K, H, W, 0.0, 1.0, ndc=True,
                        dataset_type="synthetic_ndc",
                        white_bkgd=rc.white_bkgd,
                        raw_noise_std=rc.raw_noise_std)
    return scene, (teacher_c, teacher_f)
