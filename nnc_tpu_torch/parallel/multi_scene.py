"""Multi-scene batched LSA: tune several scenes' models in one run.

Counterpart of ``nnc_tpu/parallel/multi_scene.py``. The reference stacks the
scenes' models on a leading axis and ``vmap`` s the loss over it; here a loop
over the scenes takes its place. The joint loss is the SUM of the per-scene
losses (``lsa.route``'s) and one Adam updates every scene's scales: Adam is
elementwise, so this equals independent per-scene optimizers, which is how
it runs here (``lsa.Adam`` on each scene's device). On a mesh with axes
('scene', 'data') each device group owns one scene's models and splits that
scene's ray batch over its 'data' devices (``train/lsa.py``'s data-parallel
step). The reference's ``key_schedule`` becomes :func:`scene_seeds`: every
scene draws from its own seeded ``torch.Generator``, so an independent run
of one scene with that scene's seed replays the joint run's draws.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import Mesh, make_mesh
from ..render import renderer
from ..train import lsa
from ..utils.logging import mse2psnr


def make_scene_mesh(n_scenes: int, n_devices: Optional[int] = None,
                    devices=None) -> Mesh:
    """A ('scene', 'data') mesh: ``n_devices`` devices (see
    :func:`make_mesh`) in ``n_scenes`` equal groups."""
    flat = make_mesh(n_devices, ("data",), devices=devices)
    n = flat.devices.size
    if n % n_scenes:
        raise ValueError(f"{n} devices do not divide over {n_scenes} scenes")
    return Mesh(flat.devices.reshape(n_scenes, n // n_scenes),
                ("scene", "data"))


def scene_seeds(seed: int, n_scenes: int):
    """The per-scene generator seeds that :func:`tune_multi_scene` uses for
    ``seed``: exposed so that an independent per-scene run can replay the
    draws of a joint run (pass ``seeds=[scene_seeds(seed, S)[i]]``)."""
    return [int(s) for s in
            np.random.SeedSequence(seed).generate_state(n_scenes)]


def tune_multi_scene(scenes, models_list, rc: renderer.RenderConfig, *,
                     batchers, learning_rate=1e-4, n_iters=100,
                     mesh: Optional[Mesh] = None, seed=0, verbose=True,
                     seeds: Optional[Sequence[int]] = None):
    """Joint LSA over S scenes. ``models_list``: per scene ``(model_c,
    model_f)``, whose scales are trained in place; ``scenes``: per scene a
    dict with ``near`` and ``far``; ``batchers``: per scene an object whose
    ``next_batch()`` gives (rays_o, rays_d, target) as numpy. With ``mesh``
    (axes 'scene', 'data') scene i runs on the devices of row i, on the first
    of which its models must be. ``seeds`` overrides the per-scene generator
    seeds (:func:`scene_seeds`). Returns the tuned
    per-scene scales ``[(ls_c, ls_f)]`` as {layer name: (out,)} and the
    per-scene PSNR of the last step's fine image loss."""
    S = len(scenes)
    if not (len(models_list) == len(batchers) == S):
        raise ValueError("scenes, models_list and batchers differ in length")
    if mesh is not None and mesh.shape.get("scene") != S:
        raise ValueError(f"{S} scenes on a mesh of shape {mesh.shape}")
    seeds = scene_seeds(seed, S) if seeds is None else list(seeds)
    route = lsa.route(rc)

    per_scene = []
    for i, (model_c, model_f) in enumerate(models_list):
        trained = lsa.trained_tensors(model_c, model_f)
        places, others = [(model_c.device, model_c, model_f)], []
        if mesh is not None:
            row = Mesh(mesh.devices[i], ("data",))
            places, others = lsa.make_places(row, model_c, model_f)
        generator = torch.Generator(device=model_c.device) \
            .manual_seed(seeds[i])
        per_scene.append((lsa.Adam(trained), places, others, generator))

    img_losses = [None] * S
    for it in range(n_iters):
        hyper = lsa.Adam.hyper(learning_rate, it)
        for i, (adam, places, others, generator) in enumerate(per_scene):
            device = places[0][0]
            ro, rd, tgt = batchers[i].next_batch()
            vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
            batch = torch.as_tensor(np.concatenate([ro, rd, vd, tgt], -1),
                                    dtype=torch.float32, device=device)
            for t in adam.trained:
                t.grad = None
            _loss, img_losses[i] = lsa.sharded_loss_backward(
                places, lsa.shard_batch(batch, places), scenes[i]["near"],
                scenes[i]["far"], rc,
                route.draws(batch.shape[0], generator, device), route.loss)
            lsa.reduce_grads(adam.trained, others)
            adam.update([t.grad for t in adam.trained],
                        torch.from_numpy(hyper).to(device))
            lsa.broadcast(adam.trained, others)
    psnrs = [mse2psnr(float(m)) for m in img_losses]
    if verbose:
        print(f"multi-scene LSA, {S} scenes, {n_iters} steps: last-step "
              f"PSNR {[round(p, 3) for p in psnrs]}")

    def scales(model):
        return {name: layer.weight_scaling.detach().reshape(-1).clone()
                for name, layer in model.layers().items()}

    return [(scales(mc), scales(mf)) for mc, mf in models_list], psnrs
