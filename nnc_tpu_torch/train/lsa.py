"""LSA fine-tuning: train per-output-channel weight scales by rendering rays
and backpropagating photometric MSE through the volume renderer.

Counterpart of ``nnc_tpu/train/lsa.py`` (reference hot loop: run_nerf.py:
685-799; loss at :741-752; scale-only grads: pytorch_model/__init__.py:
1129-1145). The TPU package batches steps into
one ``lax.scan`` call to amortise dispatch; here each step is a plain
iteration: render the batch coarse then fine (the MLP through kernel pair
K-B1 with ``use_fused_train``), the double MSE loss, backward, one Adam
update of the trained tensors. With an occupancy ``grid`` the loss is
:func:`double_mse_loss_occ`: both networks integrate the grid-selected
samples instead of the hierarchical sweep.

With a ``mesh`` (``parallel.Mesh``) the step is data-parallel: the ray batch
and its random draws, drawn once for the whole batch, are split over the
mesh's 'data' devices; each shard's loss and backward run on its device with
that device's replica of the models; the loss and the gradients are the mean
over the equal shards, summed in mesh order into the first replica, which
takes the one Adam step; the updated tensors are copied to the other
replicas. A mesh run therefore equals the single-device run on the same
draws up to the order of the float32 sums.

The random draws of a step (stratified jitter, ``sample_pdf``'s u, the raw
noise) come from a ``torch.Generator`` on the render device seeded with
``seed``, or from a ``draws`` callable, so that a test can replay the JAX
package's draws.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .. import parallel
from ..render import occupancy, renderer
from ..render.volume import raw2outputs
from ..utils.logging import ResultLogger, mse2psnr

BETAS = (0.9, 0.999)
EPS = 1e-8


def double_mse_loss(model_c, model_f, rays_o, rays_d, viewdirs, target, near,
                    far, rc: renderer.RenderConfig,
                    draws: Optional[dict] = None,
                    generator: Optional[torch.Generator] = None):
    """loss = mse(fine, target) + mse(coarse, target); returns (loss,
    img_loss), differentiable in whatever the models' tensors require.
    ``draws``: optional ``t_rand`` / ``u`` / ``noise0`` / ``noise1`` of the
    training render (renderer.render_rays); the rest come from
    ``generator``."""
    if viewdirs is None:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    out = renderer.render_rays(model_c, model_f, rays_o, rays_d, viewdirs,
                               near, far, rc, deterministic=False,
                               generator=generator, **(draws or {}))
    img_loss = torch.mean((out["rgb_map"] - target) ** 2)
    loss = img_loss
    if "rgb0" in out:
        loss = loss + torch.mean((out["rgb0"] - target) ** 2)
    return loss, img_loss


def double_mse_loss_occ(model_c, model_f, rays_o, rays_d, viewdirs, target,
                        near, far, rc: renderer.RenderConfig, grid,
                        n_candidates: int = 64, budget: int = 32,
                        draws: Optional[dict] = None,
                        generator: Optional[torch.Generator] = None):
    """Occupancy-accelerated LSA loss (reference: nnc_tpu/train/lsa.py:
    56-100): the rays' samples are selected on ``grid`` without gradient
    (``budget`` of ``n_candidates`` a ray, render/occupancy.py), and both
    networks integrate the SAME z with ``raw2outputs(dists=)``, their MLP
    on the training route (K-B1 with ``use_fused_train``). Returns (loss,
    img_loss) as :func:`double_mse_loss`. ``draws``: optional ``noise0`` /
    ``noise1`` (R, budget), the raw noise of the coarse / fine network; the
    rest come from ``generator``, in that order."""
    if viewdirs is None:
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    with torch.no_grad():
        z, dists, _ = occupancy.select_occupied_samples(
            grid.to(rays_o.device), rays_o, rays_d, near, far, n_candidates,
            budget)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
    noise = dict(draws or {})
    if rc.raw_noise_std > 0:
        for k in ("noise0", "noise1"):
            if noise.get(k) is None:
                noise[k] = torch.randn(z.shape, generator=generator,
                                       device=z.device)

    def one(model, key):
        raw = renderer._query_mlp(model, pts, viewdirs, rc, allow_fused=False)
        return raw2outputs(raw, z, rays_d, rc.raw_noise_std, rc.white_bkgd,
                           noise=noise.get(key), dists=dists)["rgb_map"]

    fine = model_f if model_f is not None else model_c
    img_loss = torch.mean((one(fine, "noise1") - target) ** 2)
    loss = img_loss + torch.mean((one(model_c, "noise0") - target) ** 2)
    return loss, img_loss


def occ_step_draws(n_rays: int, rc: renderer.RenderConfig, budget: int,
                   generator: torch.Generator, device=None) -> dict:
    """The random draws of one :func:`double_mse_loss_occ` of ``n_rays``
    rays, in the order in which it takes them from a generator."""
    if rc.raw_noise_std <= 0:
        return {}
    return {k: torch.randn((n_rays, budget), generator=generator,
                           device=device) for k in ("noise0", "noise1")}


def make_lr_schedule(lr: float, decay: float, steps_per_epoch: int,
                     offset: int = 0) -> Callable[[int], float]:
    """Per-epoch staircase decay (torch StepLR semantics; decay=0 disables):
    the learning rate of the update that follows ``count`` earlier ones.
    ``offset`` shifts the count, for a resume without optimizer state.
    (reference: pytorch_model/__init__.py:1161-1167)"""
    if not decay:
        return lambda count: lr
    return lambda count: lr * decay ** ((count + offset) // steps_per_epoch)


def trained_tensors(model_c, model_f, tune_scales=True, tune_biases=False):
    """Mark what trains and return it, in a fixed order: every layer's
    ``weight_scaling`` of both models (attached as ones where absent) unless
    fine-tuning without LSA, then the biases when ``tune_biases``. Nothing
    else requires grad."""
    scales, biases = [], []
    for model in (model_c, model_f):
        if model is None:
            continue
        for layer in model.layers().values():
            if layer.weight_scaling is None:
                layer.weight_scaling = torch.ones(
                    layer.weight.shape[0], 1, device=layer.weight.device)
            layer.weight.requires_grad_(False)
            scales.append(layer.weight_scaling)
            biases.append(layer.bias)
    train_scales = tune_scales or not tune_biases
    for t in scales:
        t.requires_grad_(train_scales)
    for t in biases:
        t.requires_grad_(tune_biases)
    return (scales if train_scales else []) + (biases if tune_biases else [])


def opt_state_fits(opt_state, trained) -> bool:
    """Whether a saved optimizer state ({"count", "adam"}) has the moments of
    exactly these tensors: the same number, each of the same shape."""
    if not isinstance(opt_state, dict) or set(opt_state) != {"count", "adam"}:
        return False
    adam = opt_state["adam"]
    if len(adam.get("param_groups", [])) != 1 or \
            len(adam["param_groups"][0]["params"]) != len(trained):
        return False
    state = adam.get("state", {})
    if len(state) != len(trained):
        return False
    for i, t in enumerate(trained):
        s = state.get(i)
        if s is None or any(tuple(s[k].shape) != tuple(t.shape)
                            for k in ("exp_avg", "exp_avg_sq")):
            return False
    return True


def make_places(mesh, model_c, model_f, tune_scales=True, tune_biases=False):
    """The shards of a data-parallel step over ``mesh``: ``(places,
    others)``. ``places`` holds one ``(device, model_c, model_f)`` per 'data'
    device, the given models themselves on the first, which must be their
    device, and one replica per other distinct device; ``others`` holds the
    trained tensors of each such replica, in :func:`trained_tensors`'
    order."""
    devices = parallel.data_devices(mesh)
    if model_c.device != devices[0]:
        raise ValueError(f"the models are on {model_c.device}, the mesh's "
                         f"first data device is {devices[0]}")
    rep_c = parallel.replicate_params(mesh, model_c)
    rep_f = {d: None for d in devices} if model_f is None \
        else parallel.replicate_params(mesh, model_f)
    places = [(d, rep_c[d], rep_f[d]) for d in devices]
    others = [trained_tensors(rep_c[d], rep_f[d], tune_scales, tune_biases)
              for d in dict.fromkeys(devices[1:]) if d != devices[0]]
    return places, others


def sharded_loss_backward(places, batch, near, far, rc, draws: dict,
                          loss_fn=double_mse_loss):
    """One data-parallel loss and backward. ``batch``: (rays_o, rays_d,
    viewdirs, target) of the whole step on the first device, ``draws`` its
    random draws; both are split in ray order into equal parts over
    ``places``. Every shard's gradient, scaled to the mean over the shards,
    is accumulated in its replica's ``.grad``. ``loss_fn``:
    :func:`double_mse_loss` or a loss of its signature. Returns the mean
    (loss, img_loss), detached, on the first device."""
    n = len(places)
    n_rays = batch[0].shape[0]
    if n_rays % n:
        raise ValueError(f"{n_rays} rays do not divide over {n} shards")
    part = n_rays // n
    first = places[0][0]
    total = None
    for i, (d, m_c, m_f) in enumerate(places):
        cut = lambda t: t[i * part:(i + 1) * part].to(d)
        loss, img_loss = loss_fn(
            m_c, m_f, *(cut(t) for t in batch), near, far, rc,
            draws={k: cut(v) for k, v in draws.items()})
        (loss / n).backward()
        both = torch.stack([loss.detach(), img_loss.detach()]).to(first) / n
        total = both if total is None else total + both
    return total[0], total[1]


def reduce_grads(trained, others) -> None:
    """Add the other replicas' gradients to the first replica's, replica by
    replica in mesh order, and clear them."""
    for tensors in others:
        for t, o in zip(trained, tensors):
            t.grad = t.grad + o.grad.to(t.device)
            o.grad = None


def broadcast(trained, others) -> None:
    """Copy the first replica's trained tensors to the other replicas."""
    with torch.no_grad():
        for tensors in others:
            for t, o in zip(trained, tensors):
                o.copy_(t)


def _as_tensor(a, device):
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def tune_lsa_scales(model_c, model_f, batcher, rc, near, far, *,
                    learning_rate=1e-4, learning_rate_decay=0.1, epochs=2,
                    n_iters=1000, i_save=0, basedir_save=None,
                    global_step0=0, seed=451, verbose=True, save_hook=None,
                    tune_biases=False, tune_scales=True, opt_state0=None,
                    draws: Optional[Callable[[int], dict]] = None,
                    mesh: Optional[parallel.Mesh] = None, grid=None,
                    occ_candidates: int = 64, occ_budget: int = 32):
    """Run the full LSA optimization on the models' own tensors (trained in
    place). Returns (ls_c, ls_f, mean_psnr, mean_loss (of the last epoch),
    global_step, biases): ``ls_*`` as {layer name: (out,)}, ``biases`` as
    ({name: (out,)}, {name: (out,)}) when ``tune_biases`` (fine-tuning),
    else None.

    ``save_hook(global_step, model_c, model_f, opt_state)`` is called at step
    1 and every ``i_save`` steps; ``opt_state`` ({"count": updates so far,
    "adam": the optimizer's state_dict}) resumes a later call as
    ``opt_state0``. A state that does not fit the trained tensors is
    dropped (fresh moments), and then, as without one, a resume at
    ``global_step0`` offsets the schedule. ``draws(i)`` gives the random
    draws of this call's i-th step (0-based) in place of the generator's.
    ``mesh``: run each step data-parallel over its 'data' devices (see the
    module docstring); the models must be on the first of them. ``grid``
    (an ``occupancy.OccupancyGrid``): train on :func:`double_mse_loss_occ`
    with ``occ_candidates`` / ``occ_budget``.
    """
    device = model_c.device
    trained = trained_tensors(model_c, model_f, tune_scales, tune_biases)
    places = others = None
    if mesh is not None:
        places, others = make_places(mesh, model_c, model_f, tune_scales,
                                     tune_biases)
    optimizer = torch.optim.Adam(trained, lr=learning_rate, betas=BETAS,
                                 eps=EPS)
    count = 0
    offset = global_step0
    if opt_state0 is not None:
        if opt_state_fits(opt_state0, trained):
            optimizer.load_state_dict(opt_state0["adam"])
            count = int(opt_state0["count"])
            offset = 0
        else:
            print("INFO: saved optimizer state does not fit the tuned "
                  "tensors; restarting moments with schedule offset")
    schedule = make_lr_schedule(learning_rate, learning_rate_decay, n_iters,
                                offset=offset)
    generator = torch.Generator(device=device).manual_seed(seed)
    loss_fn = double_mse_loss
    if grid is not None:
        loss_fn = lambda *a, **kw: double_mse_loss_occ(
            *a, grid=grid, n_candidates=occ_candidates, budget=occ_budget,
            **kw)
    logger = ResultLogger(basedir_save) if basedir_save else None

    def get_batch():
        batch = batcher.next_batch()
        if len(batch) == 4:
            ro, rd, vd, tgt = batch
        else:
            ro, rd, tgt = batch
            vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
        return tuple(_as_tensor(a, device) for a in (ro, rd, vd, tgt))

    global_step = global_step0
    step = 0
    mean_psnr = mean_loss = 0.0
    for _epoch in range(epochs):
        psnrs, losses = [], []
        for _it in range(n_iters):
            ro, rd, vd, tgt = get_batch()
            for group in optimizer.param_groups:
                group["lr"] = schedule(count)
            optimizer.zero_grad(set_to_none=True)
            step_draws = None if draws is None else draws(step)
            if places is None:
                loss, img_loss = loss_fn(
                    model_c, model_f, ro, rd, vd, tgt, near, far, rc,
                    draws=step_draws, generator=generator)
                loss.backward()
            else:
                made = renderer.step_draws(ro.shape[0], rc, generator,
                                           device) if grid is None else \
                    occ_step_draws(ro.shape[0], rc, occ_budget, generator,
                                   device)
                step_draws = {**made, **(step_draws or {})}
                loss, img_loss = sharded_loss_backward(
                    places, (ro, rd, vd, tgt), near, far, rc, step_draws,
                    loss_fn)
                reduce_grads(trained, others)
            optimizer.step()
            if others:
                broadcast(trained, others)
            count += 1
            step += 1
            global_step += 1
            loss_v = float(loss.detach())
            psnr_v = mse2psnr(float(img_loss.detach()))
            psnrs.append(psnr_v)
            losses.append(loss_v)
            if logger is not None:
                logger.append(psnr_v, loss_v)
            if i_save and (global_step == 1 or global_step % i_save == 0) \
                    and save_hook is not None:
                save_hook(global_step, model_c, model_f,
                          {"count": count, "adam": optimizer.state_dict()})
        mean_psnr = float(np.mean(psnrs))
        mean_loss = float(np.mean(losses))
        if verbose:
            print(f"Epoch done. mean PSNR {mean_psnr:.3f}, "
                  f"mean loss {mean_loss:.6f}")
    if logger is not None:
        logger.flush()

    def vectors(model, attr):
        if model is None:
            return {}
        return {name: getattr(layer, attr).detach().reshape(-1).clone()
                for name, layer in model.layers().items()}

    biases = (vectors(model_c, "bias"), vectors(model_f, "bias")) \
        if tune_biases else None
    return (vectors(model_c, "weight_scaling"),
            vectors(model_f, "weight_scaling"), mean_psnr, mean_loss,
            global_step, biases)
