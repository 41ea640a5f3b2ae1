"""LSA fine-tuning: train per-output-channel weight scales by rendering rays
and backpropagating photometric MSE through the volume renderer.

Counterpart of ``nnc_tpu/train/lsa.py`` (reference hot loop: run_nerf.py:
685-799; loss at :741-752; scale-only grads: pytorch_model/__init__.py:
1129-1145). A step (:func:`make_train_step`) renders its batch coarse then
fine (the MLP through kernel pair K-B1 with ``use_fused_train``), takes the
double MSE loss and its backward, and makes one Adam update of the trained
tensors (:class:`Adam`: optax's update as tensor ops, its learning rate and
bias corrections read from a tensor). With an occupancy ``grid`` the loss is
:func:`double_mse_loss_occ`: both networks integrate the grid-selected
samples instead of the hierarchical sweep. With a mip-NeRF configuration
(``mipnerf.MipRenderConfig``) there is one network (``model_f`` None), and
the step's loss is :func:`mipnerf.mip_loss` on its two levels, its draws
from :func:`mipnerf.step_draws`.

The steps run in calls, scheduled as the reference's loop schedules them
(:func:`call_lengths`): a full call takes ``steps_per_call`` (K) steps, as
the reference's ``lax.scan`` over K pre-sampled batches does, and the
remainders before an i_save or an epoch's end run as single steps. A call
packs its batches on the host into one (K, N, 12) array [rays_o | rays_d |
viewdirs | target] followed by the K steps' (learning rate, bias
corrections), uploads it once, and reads the K (loss, img_loss) pairs back
once (:class:`ScanTrainStep`). On a CUDA device a full call is one replay of
a ``torch.cuda.CUDAGraph`` that captured its K steps, K-B1's launches among
them; the graph is captured at the run's first full call after one step of
warm-up whose effect is undone, and a failed capture raises. On the CPU, and
for single steps, the same steps run eagerly inside the call.

With a ``mesh`` (``parallel.Mesh``) every step is data-parallel: the ray
batch and its random draws, drawn once for the whole batch, are split over
the mesh's 'data' devices; each shard's loss and backward run on its device
with that device's replica of the models; the loss and the gradients are the
mean over the equal shards, summed in mesh order into the first replica,
which takes the one Adam step; the updated tensors are copied to the other
replicas. A mesh run therefore equals the single-device run on the same
draws up to the order of the float32 sums. A full call's stack is uploaded
once to the first device and split along its ray axis by
``parallel.shard_scan_inputs``, as the reference shards its scan; its K
steps run eagerly, since the mesh's devices may differ and one graph does
not span them.

The random draws of a step (stratified jitter, ``sample_pdf``'s u, the raw
noise) come from a ``torch.Generator`` on the render device seeded with
``seed``, step by step in the order of :func:`renderer.step_draws` /
:func:`occ_step_draws`, whatever the calls' lengths, so that every
``steps_per_call`` gives the same trajectory; a ``draws`` callable can
replace them, so that a test can replay the JAX package's draws.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import parallel
from ..ops import _build, mlp_train_fused
from ..render import mipnerf, occupancy, renderer
from ..render.volume import raw2outputs
from ..utils import profiling
from ..utils.logging import ResultLogger, mse2psnr

BETAS = (0.9, 0.999)
EPS = 1e-8
BATCH_COLS = 12   # [rays_o | rays_d | viewdirs | target]
# steps that a graph's capture runs first, on a side stream, and undoes:
# their kernels launch (and count) once more than the run's steps
WARMUP_STEPS = 1
HYPER_COLS = 3    # Adam.hyper: [lr, 1 - b1^t, 1 - b2^t]


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


def points_per_ray(rc, grid=None, occ_budget: int = 32) -> int:
    """MLP points a training step computes a ray, summed over its networks
    or levels: both levels' samples (mip-NeRF), twice the occupancy budget,
    or the coarse samples and the fine pass's union."""
    if mipnerf.is_mip(rc):
        return mipnerf.NUM_LEVELS * rc.num_samples
    if grid is not None:
        return 2 * occ_budget
    fine = rc.n_samples + rc.n_importance if rc.n_importance > 0 else 0
    return rc.n_samples + fine


def make_lr_schedule(lr: float, decay: float, steps_per_epoch: int,
                     offset: int = 0) -> Callable[[int], float]:
    """Per-epoch staircase decay (torch StepLR semantics; decay=0 disables):
    the learning rate of the update that follows ``count`` earlier ones.
    ``offset`` shifts the count, for a resume without optimizer state.
    (reference: pytorch_model/__init__.py:1161-1167)"""
    if not decay:
        return lambda count: lr
    return lambda count: lr * decay ** ((count + offset) // steps_per_epoch)


def call_lengths(epochs: int, n_iters: int, steps_per_call: int,
                 i_save: int = 0, global_step0: int = 0) -> List[List[int]]:
    """The calls of a run, per epoch, as the reference's loop makes them
    (nnc_tpu/train/lsa.py:274-327): each call takes k = min(K, steps left in
    the epoch) steps, cut at the next multiple of ``i_save`` (step 1 alone,
    when the run starts at step 0), and a call cut below K runs as single
    steps, each scheduled anew. Returns each epoch's call lengths: K for a
    full call, 1 for a single step."""
    out, step = [], global_step0
    for _ in range(epochs):
        calls, it = [], 0
        while it < n_iters:
            k = min(steps_per_call, n_iters - it)
            if i_save:
                to_boundary = 1 if step == 0 else i_save - step % i_save
                k = max(1, min(k, to_boundary))
            if k < steps_per_call:
                k = 1
            calls.append(k)
            it += k
            step += k
        out.append(calls)
    return out


class Adam:
    """``optax.adam(lr, b1=0.9, b2=0.999, eps=1e-8)`` over ``trained`` (the
    reference's optimizer), as tensor ops a CUDA graph can capture: the two
    moments are flat float32 vectors on the tensors' device, and an update
    reads its learning rate and bias corrections from a (3,) tensor made by
    :meth:`hyper`, so that no step goes back to the host. The tensors are
    updated in place."""

    def __init__(self, trained):
        self.trained = list(trained)
        self.sizes = [t.numel() for t in self.trained]
        device = self.trained[0].device
        self.m = torch.zeros(sum(self.sizes), device=device)
        self.v = torch.zeros(sum(self.sizes), device=device)

    @staticmethod
    def hyper(lr: float, count: int) -> np.ndarray:
        """[lr, 1 - b1^t, 1 - b2^t] in float32 for the update that follows
        ``count`` earlier ones (t = count + 1), as optax works them out."""
        t = np.float32(count + 1)
        b1, b2 = np.float32(BETAS[0]), np.float32(BETAS[1])
        return np.array([lr, 1 - b1 ** t, 1 - b2 ** t], np.float32)

    @torch.no_grad()
    def update(self, grads, hyper: torch.Tensor) -> None:
        """One update from ``grads`` (one per trained tensor; None counts as
        zero, as optax treats a zero gradient) and ``hyper``."""
        g = torch.cat([(torch.zeros_like(t) if d is None else d).reshape(-1)
                       for t, d in zip(self.trained, grads)])
        b1, b2 = BETAS
        self.m.mul_(b1).add_(g, alpha=1 - b1)
        self.v.mul_(b2).addcmul_(g, g, value=1 - b2)
        step = self.m / hyper[1] / (torch.sqrt(self.v / hyper[2]) + EPS) \
            * -hyper[0]
        torch._foreach_add_(self.trained, [s.view_as(t) for s, t in zip(
            step.split(self.sizes), self.trained)])

    def state_dict(self) -> dict:
        """The moments in ``torch.optim.Adam.state_dict()``'s layout (the
        step count is kept beside it, :func:`tune_lsa_scales`)."""
        pairs = zip(self.m.split(self.sizes), self.v.split(self.sizes),
                    self.trained)
        return {"state": {i: {"exp_avg": m.view_as(t).clone(),
                              "exp_avg_sq": v.view_as(t).clone()}
                          for i, (m, v, t) in enumerate(pairs)},
                "param_groups": [{"params": list(range(len(self.trained))),
                                  "betas": BETAS, "eps": EPS}]}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        for flat, key in ((self.m, "exp_avg"), (self.v, "exp_avg_sq")):
            flat.copy_(torch.cat([state["state"][i][key].reshape(-1)
                                  .to(flat) for i in range(len(self.sizes))]))


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


def shard_batch(batch: torch.Tensor, places) -> List[torch.Tensor]:
    """A (N, 12) packed batch split in ray order into equal parts, one on
    each place's device."""
    n = len(places)
    if batch.shape[0] % n:
        raise ValueError(f"{batch.shape[0]} rays do not divide over {n} "
                         f"shards")
    return [part.to(d) for part, (d, *_m) in zip(torch.chunk(batch, n),
                                                 places)]


def sharded_loss_backward(places, shards, near, far, rc, draws: dict,
                          loss_fn=double_mse_loss):
    """One data-parallel loss and backward. ``shards``: one packed (n, 12)
    batch [rays_o | rays_d | viewdirs | target] per place, on its device,
    equal parts in ray order of the step's batch (:func:`shard_batch`,
    ``parallel.shard_scan_inputs``); ``draws``: the whole batch's random
    draws on the first device, split here in the same way. Every shard's
    gradient, scaled to the mean over the shards, is accumulated in its
    replica's ``.grad``. ``loss_fn``: :func:`double_mse_loss` or a loss of
    its signature. Returns the mean (loss, img_loss), detached, on the first
    device."""
    n = len(places)
    sizes = [s.shape[0] for s in shards]
    if len(set(sizes)) != 1:
        raise ValueError(f"shards of unequal sizes {sizes}")
    part = sizes[0]
    first = places[0][0]
    total = None
    for i, ((d, m_c, m_f), b) in enumerate(zip(places, shards)):
        cut = lambda t: t[i * part:(i + 1) * part].to(d)
        loss, img_loss = loss_fn(
            m_c, m_f, b[:, 0:3], b[:, 3:6], b[:, 6:9], b[:, 9:12], near, far,
            rc, draws={k: cut(v) for k, v in draws.items()})
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


def make_train_step(model_c, model_f, rc, near, far, adam: Adam,
                    loss_fn=double_mse_loss, places=None, others=None):
    """One LSA step as a function ``step(batch, draws, hyper) -> (2,)
    [loss, img_loss]`` (reference: nnc_tpu/train/lsa.py:111-128): the loss
    of the packed (N, 12) ``batch`` [rays_o | rays_d | viewdirs | target]
    on the step's ``draws``, its gradient in ``adam``'s tensors and one
    update with ``hyper`` (:meth:`Adam.hyper` on the device). With
    ``places`` / ``others`` (:func:`make_places`) the step is data-parallel
    and ``batch`` is the list of its shards instead. Nothing in it waits for
    the host, so a CUDA graph can capture it."""
    trained = adam.trained

    def train_step(batch, draws, hyper):
        loss, img_loss = loss_fn(
            model_c, model_f, batch[:, 0:3], batch[:, 3:6], batch[:, 6:9],
            batch[:, 9:12], near, far, rc, draws=draws)
        grads = torch.autograd.grad(loss, trained, allow_unused=True)
        adam.update(grads, hyper)
        return torch.stack([loss.detach(), img_loss.detach()])

    def mesh_step(shards, draws, hyper):
        for t in trained:
            t.grad = None
        loss, img_loss = sharded_loss_backward(places, shards, near, far, rc,
                                               draws, loss_fn)
        reduce_grads(trained, others)
        adam.update([t.grad for t in trained], hyper)
        broadcast(trained, others)
        return torch.stack([loss, img_loss])

    return train_step if places is None else mesh_step


def pack_call(batches, hypers) -> np.ndarray:
    """A call's host inputs as one float32 vector: its K packed (N, 12)
    batches, then its K (3,) :meth:`Adam.hyper` rows."""
    return np.concatenate([np.stack(batches).reshape(-1),
                           np.stack(hypers).reshape(-1)]).astype(np.float32)


def _upload(host: np.ndarray, device, out=None) -> torch.Tensor:
    """The one host-to-device copy of a call's inputs (into ``out`` if
    given)."""
    t = torch.from_numpy(host)
    if out is None:
        return t.to(device)
    return out.copy_(t)


def _readback(t: torch.Tensor) -> np.ndarray:
    """The one device-to-host copy of a call's (K, 2) losses."""
    return t.cpu().numpy()


class ScanTrainStep:
    """K steps of a :func:`make_train_step` step in one call (reference:
    ``make_scan_train_step``, nnc_tpu/train/lsa.py:131-163): ``call(host,
    draws)`` takes :func:`pack_call`'s vector and the K steps' draw dicts,
    uploads the vector once, runs the K steps and reads their (K, 2)
    [loss, img_loss] back once.

    ``graph`` (single device, CUDA): the first call warms one step up on a
    side stream and restores the trained tensors and the moments, then
    captures the K steps in a ``torch.cuda.CUDAGraph`` that reads the K
    batches from one static (K, N, 12) device buffer and the draws from
    static (K, ...) stacks, which every call refills before its replay. A
    failed capture raises. The kernels' launch counts
    (``_build.count_launch``) tick in Python, so the launches seen during
    the capture (``captured``) are counted at every replay instead. The
    graph keeps the K-B1 weight buffers (``mlp_train_fused.TRAIN_PACKS``)
    it read, so that the cache cannot free them under a replay. ``capture_s`` and
    ``pool_bytes`` (the peak of the memory allocated during the capture
    above what was allocated before it, the graph's private pool) record
    the capture. Otherwise (the CPU, single steps, ``graph=False``) the
    steps run eagerly inside the call. ``mesh``: the stack is split along
    its ray axis over the mesh's 'data' devices
    (``parallel.shard_scan_inputs``) and every step takes its shards."""

    def __init__(self, train_step, adam: Adam, k: int, n_rays: int, device,
                 graph: bool = False, mesh=None):
        self.train_step, self.adam, self.k = train_step, adam, k
        self.n_rays = n_rays
        self.device = torch.device(device)
        self.mesh = mesh
        self.graph = graph
        if graph and (mesh is not None or self.device.type != "cuda"):
            raise ValueError("a CUDA graph needs one CUDA device")
        if mesh is not None and n_rays % len(parallel.data_devices(mesh)):
            raise ValueError(f"{n_rays} rays do not divide over "
                             f"{len(parallel.data_devices(mesh))} shards")
        self._graph = None
        self.captured = {}
        self.replays = 0
        self.capture_s = 0.0
        self.pool_bytes = 0

    def _views(self, flat):
        cut = self.k * self.n_rays * BATCH_COLS
        return (flat[:cut].view(self.k, self.n_rays, BATCH_COLS),
                flat[cut:].view(self.k, HYPER_COLS))

    def __call__(self, host: np.ndarray, draws: List[dict]) -> np.ndarray:
        if self.graph:
            return self._replay(host, draws)
        with profiling.span("nnc.lsa.upload"):
            packed, hyper = self._views(_upload(host, self.device))
            if self.mesh is not None:
                parts = parallel.shard_scan_inputs(self.mesh, packed)
                packed = [[p[i] for p in parts] for i in range(self.k)]
        with profiling.span("nnc.lsa.steps"):
            out = torch.stack([self.train_step(
                packed[i],
                {n: v.to(self.device) for n, v in draws[i].items()},
                hyper[i]) for i in range(self.k)])
        with profiling.span("nnc.lsa.readback"):
            return _readback(out)

    def _replay(self, host, draws):
        if self._graph is None:
            self._static = torch.empty(host.shape, dtype=torch.float32,
                                       device=self.device)
            self._stacks = {n: torch.empty((self.k, *v.shape), dtype=v.dtype,
                                           device=self.device)
                            for n, v in draws[0].items()}
        with profiling.span("nnc.lsa.upload"):
            _upload(host, self.device, out=self._static)
            for i, d in enumerate(draws):
                for n, v in d.items():
                    self._stacks[n][i].copy_(v)
        if self._graph is None:
            with profiling.span("nnc.lsa.capture"):
                self._capture()
        with profiling.span("nnc.lsa.steps"):
            self._graph.replay()
        self.replays += 1
        _build.add_launches(self.captured)
        with profiling.span("nnc.lsa.readback"):
            return _readback(self._losses)

    def _step_args(self, i):
        packed, hyper = self._views(self._static)
        return packed[i], {n: s[i] for n, s in self._stacks.items()}, hyper[i]

    def _capture(self):
        dev, adam = self.device, self.adam
        saved = [t.detach().clone() for t in adam.trained] + \
            [adam.m.clone(), adam.v.clone()]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self.train_step(*self._step_args(0))
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.no_grad():
            for t, s in zip(adam.trained + [adam.m, adam.v], saved):
                t.copy_(s)
        torch.cuda.synchronize(dev)
        del saved
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with _build.recording_launches() as captured, \
                torch.cuda.graph(graph):
            self._losses = torch.stack([self.train_step(*self._step_args(i))
                                        for i in range(self.k)])
        torch.cuda.synchronize(dev)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.max_memory_allocated(dev) - base
        self.captured = dict(captured)
        self._keep = mlp_train_fused.TRAIN_PACKS.entries()
        self._graph = graph


def tune_lsa_scales(model_c, model_f, batcher, rc, near, far, *,
                    learning_rate=1e-4, learning_rate_decay=0.1, epochs=2,
                    n_iters=1000, i_save=0, basedir_save=None,
                    global_step0=0, seed=451, verbose=True, save_hook=None,
                    tune_biases=False, tune_scales=True, opt_state0=None,
                    draws: Optional[Callable[[int], dict]] = None,
                    mesh: Optional[parallel.Mesh] = None, grid=None,
                    occ_candidates: int = 64, occ_budget: int = 32,
                    steps_per_call: int = 8, stats: Optional[dict] = None):
    """Run the full LSA optimization on the models' own tensors (trained in
    place). Returns (ls_c, ls_f, mean_psnr, mean_loss (of the last epoch),
    global_step, biases): ``ls_*`` as {layer name: (out,)}, ``biases`` as
    ({name: (out,)}, {name: (out,)}) when ``tune_biases`` (fine-tuning),
    else None.

    The steps run in calls of ``steps_per_call`` (see the module docstring
    and :func:`call_lengths`); every value of it gives the same trajectory.
    ``save_hook(global_step, model_c, model_f, opt_state)`` is called at
    step 1 and every ``i_save`` steps, which always end a call;
    ``opt_state`` ({"count": updates so far, "adam": the moments in
    ``torch.optim.Adam``'s state_dict layout}) resumes a later call as
    ``opt_state0``. A state that does not fit the trained tensors is
    dropped (fresh moments), and then, as without one, a resume at
    ``global_step0`` offsets the schedule. ``draws(i)`` gives the random
    draws of this run's i-th step (0-based) in place of the generator's.
    ``mesh``: run each step data-parallel over its 'data' devices (see the
    module docstring); the models must be on the first of them. ``grid``
    (an ``occupancy.OccupancyGrid``): train on :func:`double_mse_loss_occ`
    with ``occ_candidates`` / ``occ_budget``. ``stats``: a dict that
    receives every call's (steps, wall seconds from its batches to its
    readback, whether it captured the graph) as ``calls``, the graph's
    ``capture_s``, ``pool_bytes`` and ``captured`` launches, and the
    ``warmup_steps`` run before the capture. While a torch profiler
    records, each call is an ``nnc.lsa.call`` request span
    (``utils/profiling``; counts ``steps``, ``rays``, the call's rays, and
    ``points``, the MLP points its steps compute, :func:`points_per_ray`)
    over the interval ``calls`` times, its phases the spans
    ``nnc.lsa.batches``, ``.pack``, ``.draws``, ``.upload``, ``.capture``
    (the first full call), ``.steps`` and ``.readback``.
    """
    device = model_c.device
    trained = trained_tensors(model_c, model_f, tune_scales, tune_biases)
    places = others = None
    if mesh is not None:
        places, others = make_places(mesh, model_c, model_f, tune_scales,
                                     tune_biases)
    adam = Adam(trained)
    count = 0
    offset = global_step0
    if opt_state0 is not None:
        if opt_state_fits(opt_state0, trained):
            adam.load_state_dict(opt_state0["adam"])
            count = int(opt_state0["count"])
            offset = 0
        else:
            print("INFO: saved optimizer state does not fit the tuned "
                  "tensors; restarting moments with schedule offset")
    schedule = make_lr_schedule(learning_rate, learning_rate_decay, n_iters,
                                offset=offset)
    generator = torch.Generator(device=device).manual_seed(seed)
    loss_fn = double_mse_loss
    mip = mipnerf.is_mip(rc)
    if mip:
        if grid is not None or mesh is not None or model_f is not None:
            raise ValueError("mip-NeRF tunes one network on its cones, on "
                             "one device: no fine network, occupancy grid "
                             "or mesh")
        loss_fn = mipnerf.mip_loss
    if grid is not None:
        loss_fn = lambda *a, **kw: double_mse_loss_occ(
            *a, grid=grid, n_candidates=occ_candidates, budget=occ_budget,
            **kw)
    train_step = make_train_step(model_c, model_f, rc, near, far, adam,
                                 loss_fn, places, others)
    logger = ResultLogger(basedir_save) if basedir_save else None

    def get_batch():
        batch = batcher.next_batch()
        if len(batch) == 4:
            ro, rd, vd, tgt = batch
        else:
            ro, rd, tgt = batch
            vd = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
        return np.concatenate([np.asarray(a, np.float32)
                               for a in (ro, rd, vd, tgt)], axis=-1)

    def step_draws(i, n_rays):
        made = mipnerf.step_draws(n_rays, rc, generator, device) if mip \
            else renderer.step_draws(n_rays, rc, generator, device) \
            if grid is None else \
            occ_step_draws(n_rays, rc, occ_budget, generator, device)
        return {**made, **(draws(i) if draws is not None else {})}

    runners = {}

    def runner(k, n_rays):
        if (k, n_rays) not in runners:
            runners[k, n_rays] = ScanTrainStep(
                train_step, adam, k, n_rays, device, mesh=mesh,
                graph=k > 1 and mesh is None and device.type == "cuda")
        return runners[k, n_rays]

    global_step = global_step0
    step = 0
    mean_psnr = mean_loss = 0.0
    call_s = []
    for calls in call_lengths(epochs, n_iters, steps_per_call, i_save,
                              global_step0):
        psnrs, losses = [], []
        for k in calls:
            with profiling.request("nnc.lsa.call", steps=k) as call:
                t0 = time.perf_counter()
                with profiling.span("nnc.lsa.batches"):
                    batches = [get_batch() for _ in range(k)]
                n_rays = batches[0].shape[0]
                if call is not None:
                    call.counts["rays"] = k * n_rays
                    call.counts["points"] = k * n_rays * points_per_ray(
                        rc, grid, occ_budget)
                with profiling.span("nnc.lsa.pack"):
                    host = pack_call(batches, [
                        Adam.hyper(schedule(count + j), count + j)
                        for j in range(k)])
                run = runner(k, n_rays)
                capturing = run.graph and not run.replays
                with profiling.span("nnc.lsa.draws"):
                    made = [step_draws(step + j, n_rays) for j in range(k)]
                out = run(host, made)
                call_s.append((k, time.perf_counter() - t0, capturing))
            for loss_v, img_v in out:
                psnr_v = mse2psnr(float(img_v))
                psnrs.append(psnr_v)
                losses.append(float(loss_v))
                if logger is not None:
                    logger.append(psnr_v, float(loss_v))
            count += k
            step += k
            global_step += k
            if i_save and (global_step == 1 or global_step % i_save == 0) \
                    and save_hook is not None:
                save_hook(global_step, model_c, model_f,
                          {"count": count, "adam": adam.state_dict()})
        mean_psnr = float(np.mean(psnrs))
        mean_loss = float(np.mean(losses))
        if verbose:
            print(f"Epoch done. mean PSNR {mean_psnr:.3f}, "
                  f"mean loss {mean_loss:.6f}")
    if logger is not None:
        logger.flush()
    if stats is not None:
        graphs = [r for r in runners.values() if r.graph]
        stats.update(calls=call_s,
                     capture_s=sum(r.capture_s for r in graphs),
                     pool_bytes=max([r.pool_bytes for r in graphs],
                                    default=0),
                     captured={n: c for r in graphs
                               for n, c in r.captured.items()},
                     warmup_steps=WARMUP_STEPS * len(graphs))
    runners.clear()

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
