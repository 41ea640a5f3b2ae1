"""The benchmark's scenes, frozen here so that no change to the program moves
the yardstick: the solid teacher's weights, the cameras, the training
views and the random draws, all made from ``--seed``.

Nothing here imports the program. The weights are plain float32 tensors
made on the device in one draw: ``{layer: (weight (out, in), bias (out,))}``
per network, in the layer order of the published NeRF MLP (eight 256-wide
layers with a skip at layer 4, the 256-wide feature layer, the density
head, the 128-wide view layer and the colour head).

The solid teacher is the octahedron ``|x|_1 < radius`` of density
``density * relu(radius - |x|_1)`` wired through ``relu(+-x_i)`` units and
an identity chain, with a constant colour from the colour head's bias; every
weight off the density path then gets ``N(0, noise_std^2)`` so that each
product is dense. The rows that carry the density (the six ``relu(+-x_i)``
units, unit 0 of every later layer and the density head) get none: the
density head multiplies its input by ``density``, so noise there would
fill empty space with fog, and the grid and the culling would see none of
the solid's shape.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed for the part ``tag`` of a run of ``seed`` (any whole
    number that fits 64 bits)."""
    state = np.random.SeedSequence([int(seed) % 2 ** 64, tag])
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


# the parts of a run that draw from the seed
WEIGHTS, POSES, IMAGES, BATCHER, DRAWS, SAMPLE, PROGRAM = range(7)


def layer_dims(net: dict) -> dict:
    """{layer: (in, out)} of the published NeRF MLP for ``net`` (the
    configuration's ``netdepth``, ``netwidth``, ``skips``, ``multires`` and
    ``multires_views``)."""
    W = net["netwidth"]
    in_pts = 3 + 3 * 2 * net["multires"]
    in_views = 3 + 3 * 2 * net["multires_views"]
    dims, d_in = {}, in_pts
    for i in range(net["netdepth"]):
        dims[f"pts_linears.{i}"] = (d_in, W)
        d_in = W + (in_pts if i in net["skips"] else 0)
    dims["feature_linear"] = (W, W)
    dims["alpha_linear"] = (W, 1)
    dims["views_linears.0"] = (W + in_views, W // 2)
    dims["rgb_linear"] = (W // 2, 3)
    return dims


def solid_networks(net: dict, teacher: dict, n: int, seed: int, device):
    """``n`` solid teachers (``teacher``: radius, density, rgb, noise_std),
    each ``{layer: (weight, bias)}`` on ``device``; the noise of all of them
    comes from one normal draw of a generator on ``device``."""
    dims = layer_dims(net)
    in_pts = 3 + 3 * 2 * net["multires"]
    sizes = [i * o for i, o in dims.values()]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    noise = torch.randn(n * sum(sizes), generator=g, device=device)
    noise.mul_(float(teacher["noise_std"]))
    nets = []
    for k, chunk in enumerate(noise.split(sum(sizes))):
        parts = dict(zip(dims, chunk.split(sizes)))
        w = {name: parts[name].view(o, i).clone()
             for name, (i, o) in dims.items()}
        b = {name: torch.zeros(o, device=device)
             for name, (_i, o) in dims.items()}
        w["pts_linears.0"][:6] = 0.0
        for i in range(1, net["netdepth"]):
            w[f"pts_linears.{i}"][0] = 0.0
        w["alpha_linear"][0] = 0.0
        for j in range(3):
            w["pts_linears.0"][j, j] += 1.0
            w["pts_linears.0"][3 + j, j] -= 1.0
        w["pts_linears.1"][0, :6] -= 1.0
        b["pts_linears.1"][0] = float(teacher["radius"])
        skip = max(net["skips"])
        for i in range(2, net["netdepth"]):
            if i == skip + 1:
                w[f"pts_linears.{i}"][0, in_pts] += 1.0
            else:
                w[f"pts_linears.{i}"][0, 0] += 1.0
        w["alpha_linear"][0, 0] += float(teacher["density"])
        b["rgb_linear"].copy_(torch.tensor(teacher["rgb"], dtype=torch.float32,
                                           device=device))
        nets.append({name: (w[name], b[name]) for name in dims})
    return nets


def uniform_networks(net: dict, n: int, seed: int, device):
    """``n`` networks with every weight and bias drawn from U(-1/sqrt(in),
    1/sqrt(in)) of its layer (the scale of ``torch.nn.Linear``'s default
    initialisation), on ``device`` from one draw, then given visible density
    and colour as the random teachers of the port's synthetic scenes are
    (the density head's weights x40 and bias +0.5, the colour head's weights
    x20): dense weights whose pre-activations sit well away from ReLU's
    kink, as a trained network's do, and a density field that every ray
    meets."""
    dims = layer_dims(net)
    sizes = [(i + 1) * o for i, o in dims.values()]
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, WEIGHTS))
    draw = torch.rand(n * sum(sizes), generator=g, device=device)
    nets = []
    for chunk in draw.split(sum(sizes)):
        net_w = {}
        for (name, (i, o)), part in zip(dims.items(), chunk.split(sizes)):
            part = (part * 2.0 - 1.0) / math.sqrt(i)
            net_w[name] = (part[:i * o].view(o, i), part[i * o:])
        net_w["alpha_linear"][0].mul_(40.0)
        net_w["alpha_linear"][1].add_(0.5)
        net_w["rgb_linear"][0].mul_(20.0)
        nets.append(net_w)
    return nets


def networks(net: dict, teacher: dict, n: int, seed: int, device):
    """The cell's ``n`` networks: ``teacher["recipe"]`` "solid"
    (:func:`solid_networks`) or "uniform" (:func:`uniform_networks`)."""
    if teacher["recipe"] == "uniform":
        return uniform_networks(net, n, seed, device)
    return solid_networks(net, teacher, n, seed, device)


def focal_of(camera: dict) -> float:
    """The focal length in pixels: the configuration's ``focal``, else from
    ``camera_angle_x`` and the width (Blender's convention)."""
    if "focal" in camera:
        return float(camera["focal"])
    return 0.5 * camera["W"] / math.tan(0.5 * camera["camera_angle_x"])


def intrinsics(camera: dict) -> np.ndarray:
    f, H, W = focal_of(camera), camera["H"], camera["W"]
    return np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)


def look_at(theta: float, phi: float, radius: float) -> np.ndarray:
    """(3, 4) camera-to-world pose on a sphere of ``radius`` looking at the
    origin, z up (the Blender scenes' test cameras)."""
    eye = radius * np.array([math.cos(theta) * math.cos(phi),
                             math.sin(theta) * math.cos(phi),
                             math.sin(phi)], np.float32)
    forward = -eye / np.linalg.norm(eye)
    right = np.cross(forward, np.array([0.0, 0.0, 1.0], np.float32))
    right /= np.linalg.norm(right)
    up = np.cross(right, forward)
    c2w = np.stack([right, up, -forward], axis=-1)
    return np.concatenate([c2w, eye[:, None]], axis=-1).astype(np.float32)


def poses(camera: dict, n: int, seed: int, tag: int = POSES) -> np.ndarray:
    """``n`` (3, 4) poses of the configuration's camera rig from the seed:
    ``look_at`` on a cycle of evenly spaced angles from a drawn start, each
    at a drawn elevation in [-0.3, 0.3] rad; ``forward`` (LLFF): the
    identity rotation, the eye drawn in [-0.25, 0.25]^2 x [-0.1, 0.1]."""
    rng = np.random.default_rng(sub_seed(seed, tag))
    if camera["rig"] == "look_at":
        start = rng.uniform(0.0, 2 * math.pi)
        return np.stack([look_at(start + 2 * math.pi * i / n,
                                 rng.uniform(-0.3, 0.3), camera["radius"])
                         for i in range(n)])
    if camera["rig"] == "forward":
        out = []
        for _ in range(n):
            eye = np.array([rng.uniform(-0.25, 0.25), rng.uniform(-0.25, 0.25),
                            rng.uniform(-0.1, 0.1)], np.float32)
            out.append(np.concatenate([np.eye(3, dtype=np.float32),
                                       eye[:, None]], axis=-1))
        return np.stack(out)
    raise ValueError(f"unknown camera rig {camera['rig']!r}")


def rays_np(H: int, W: int, K, c2w):
    """(rays_o, rays_d), each (H, W, 3) float32: pinhole rays through the
    pixel corners' grid, x right, y up, looking down -z (OpenGL)."""
    i, j = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32), indexing="xy")
    dirs = np.stack([(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1],
                     -np.ones_like(i)], axis=-1)
    rays_d = np.sum(dirs[..., None, :] * c2w[:3, :3], axis=-1)
    rays_o = np.broadcast_to(c2w[:3, -1], rays_d.shape).copy()
    return rays_o.astype(np.float32), rays_d.astype(np.float32)


def ndc_np(H: int, W: int, focal: float, near: float, rays_o, rays_d):
    """Rays shifted to the near plane and warped to normalized device
    coordinates (forward-facing scenes), numpy float32."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    o = rays_o + t[..., None] * rays_d
    ax, ay = -2.0 * focal / W, -2.0 * focal / H
    ro = np.stack([ax * o[..., 0] / o[..., 2], ay * o[..., 1] / o[..., 2],
                   1.0 + 2.0 * near / o[..., 2]], -1)
    rd = np.stack([ax * (rays_d[..., 0] / rays_d[..., 2]
                         - o[..., 0] / o[..., 2]),
                   ay * (rays_d[..., 1] / rays_d[..., 2]
                         - o[..., 1] / o[..., 2]),
                   -2.0 * near / o[..., 2]], -1)
    return ro.astype(np.float32), rd.astype(np.float32)


def training_views(camera: dict, n_views: int, seed: int):
    """(images (n, H, W, 3) U(0, 1) float32, poses (n, 3, 4), K): the
    targets of the training cells. The step's device work does not depend
    on the target values, so they are drawn, not rendered."""
    rng = np.random.default_rng(sub_seed(seed, IMAGES))
    images = rng.random((n_views, camera["H"], camera["W"], 3),
                        dtype=np.float32)
    return images, poses(camera, n_views, seed), intrinsics(camera)


def training_draws(n_steps: int, n_rays: int, sampling: dict, noisy: bool,
                   seed: int, device):
    """The random draws of the first ``n_steps`` training steps, each a dict
    ``t_rand`` (n_rays, N_samples), ``u`` (n_rays, N_importance) in [0, 1)
    and, with raw noise, ``noise0`` / ``noise1`` standard normals of the
    coarse and the fine samples; made on ``device`` in one draw of each
    kind."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, DRAWS))
    ns, ni = sampling["N_samples"], sampling["N_importance"]
    t_rand = torch.rand((n_steps, n_rays, ns), generator=g, device=device)
    u = torch.rand((n_steps, n_rays, ni), generator=g, device=device)
    out = [{"t_rand": t_rand[i], "u": u[i]} for i in range(n_steps)]
    if noisy:
        n0 = torch.randn((n_steps, n_rays, ns), generator=g, device=device)
        n1 = torch.randn((n_steps, n_rays, ns + ni), generator=g,
                         device=device)
        for i, d in enumerate(out):
            d.update(noise0=n0[i], noise1=n1[i])
    return out
