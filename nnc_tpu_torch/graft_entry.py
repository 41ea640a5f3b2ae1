"""Entry points for a quick check of the port: the single-device render step
and the multi-device dry run.

Counterpart of ``__graft_entry__.py`` at the repository root. Both run on
CUDA devices unless the caller names others.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from . import parallel
from .data import synthetic
from .models import nerf
from .ops import mlp_tp_fused
from .parallel import multi_scene
from .render import occupancy, renderer
from .render.rays import get_rays_np
from .train import lsa
from .utils.device import resolve_device


def entry(n_rays: int = 1024, device=None,
          compute_dtype: torch.dtype = torch.bfloat16):
    """Returns (fn, example_args): a hierarchical NeRF render step on the
    flagship model (full-size 8x256 MLPs, lego's 64 + 128 samples, white
    background) over ``n_rays`` rays, computing in bf16 as the reference's
    entry does (``compute_dtype=torch.float32`` for the float32 MLP). Its
    render configuration asks for no fused kernel, so it runs the plain MLP.
    ``device`` None means the first CUDA device."""
    device = resolve_device(device)
    mlp = nerf.NeRFConfig(compute_dtype=compute_dtype)
    rc = renderer.RenderConfig(mlp=mlp, n_samples=64, n_importance=128,
                               white_bkgd=True, chunk=1024)
    g = torch.Generator().manual_seed(0)
    model_c = nerf.init_lsa_scales(nerf.init_params(mlp, g, device=device))
    model_f = nerf.init_lsa_scales(nerf.init_params(mlp, g, device=device))
    rays_o = torch.zeros(n_rays, 3, device=device)
    rays_d = torch.cat([torch.full((n_rays, 2), 0.1, device=device),
                        -torch.ones(n_rays, 1, device=device)], dim=-1)

    @torch.no_grad()
    def fn(model_c, model_f, rays_o, rays_d):
        viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
        out = renderer.render_rays(model_c, model_f, rays_o, rays_d, viewdirs,
                                   2.0, 6.0, rc, deterministic=True)
        return out["rgb_map"]

    return fn, (model_c, model_f, rays_o, rays_d)


class _FakeBatcher:
    def __init__(self, seed, n_rays):
        self.rng = np.random.default_rng(seed)
        self.n_rays = n_rays

    def next_batch(self):
        n = self.n_rays
        ro = self.rng.normal(0, 0.1, (n, 3)).astype(np.float32)
        rd = (self.rng.normal(0, 0.2, (n, 3)) - [0, 0, 1]).astype(np.float32)
        tgt = self.rng.uniform(0, 1, (n, 3)).astype(np.float32)
        return ro, rd, tgt


class _OneBatch:
    def __init__(self, batch):
        self.batch = batch

    def next_batch(self):
        return self.batch


def _finite(t, what):
    if not bool(torch.isfinite(torch.as_tensor(t)).all()):
        raise RuntimeError(f"dryrun_multichip: {what} is not finite")


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """Run every multi-device path once on tiny shapes over a mesh of
    ``n_devices`` devices (``devices`` as in ``parallel.make_mesh``: None
    means the CUDA devices PyTorch sees, repeated cyclically):

    1. one data-parallel LSA step (W=64, 8 + 8 samples, 16 rays per device)
       after the tensor-parallel placement of the weights
       (``shard_params_tp``) where the mesh has a 'model' axis. The port has
       no automatic partitioner, so the step itself runs on replicas;
    2. three more steps as one call of three steps (``steps_per_call=3``),
       its (3, N, 12) stack split over the mesh by ``shard_scan_inputs``,
       as the reference runs them as one ``lax.scan`` call;
    3. the tensor-parallel fused MLP over the 'model' axis (K-B6 on CUDA);
    4. the mesh render through the fused kernels, data-sharded;
    5. an occupancy-mode frame (an all-ones 16^3 grid, 16 candidates, 8
       samples a ray) with its rows sharded over the mesh, each shard's
       selection and K-B2 on its device, held against the same frame
       without a mesh (max |d rgb| 1e-5);
    6. joint multi-scene LSA on a ('scene', 'data') mesh, held against the
       sequential run of scene 0 (rtol 2e-4, atol 2e-6).
    Every failed check raises."""
    axes = ("data", "model") if n_devices % 2 == 0 and n_devices > 1 \
        else ("data",)
    mesh = parallel.make_mesh(n_devices, axes, devices=devices)
    first = mesh.devices.flat[0]
    g = torch.Generator().manual_seed(0)

    mlp = nerf.NeRFConfig(W=64)
    rc = renderer.RenderConfig(mlp=mlp, n_samples=8, n_importance=8,
                               chunk=16 * n_devices)
    make = lambda cfg: nerf.init_lsa_scales(
        nerf.init_params(cfg, g, device=first))
    model_c, model_f = make(mlp), make(mlp)

    if "model" in mesh.shape:
        m = mesh.shape["model"]
        for model in (model_c, model_f):
            placed = parallel.shard_params_tp(mesh, model)
            for name, layer in model.layers().items():
                w = torch.cat([p[name + ".weight"].to(first) for p in placed],
                              dim=1) if layer.weight.shape[0] % m == 0 \
                    else placed[0][name + ".weight"].to(first)
                if not torch.equal(w, layer.effective_weight().t()):
                    raise RuntimeError(f"dryrun_multichip: TP shards of "
                                       f"{name} do not reassemble")

    n_data = mesh.shape["data"]
    n_rays = 16 * n_data
    rng = np.random.default_rng(0)
    batch = (rng.normal(0, 1, (n_rays, 3)).astype(np.float32),
             (rng.normal(0, 1, (n_rays, 3)) - [0, 0, 2]).astype(np.float32),
             rng.uniform(0, 1, (n_rays, 3)).astype(np.float32))
    sharded = parallel.shard_train_inputs(mesh, *batch)
    if any(len(parts) != n_data or parts[0].shape[0] != 16
           for parts in sharded):
        raise RuntimeError("dryrun_multichip: shard_train_inputs layout")
    *_ls, _psnr, loss, _step, _b = lsa.tune_lsa_scales(
        model_c, model_f, _OneBatch(batch), rc, 2.0, 6.0, epochs=1,
        n_iters=1, verbose=False, mesh=mesh)
    _finite(loss, "the data-parallel LSA step's loss")
    print(f"dryrun_multichip({n_devices}) OK on mesh {mesh.shape}: "
          f"loss={loss:.5f}")

    K = 3
    stats = {}
    out = lsa.tune_lsa_scales(
        model_c, model_f, _OneBatch(batch), rc, 2.0, 6.0, epochs=1,
        n_iters=K, seed=4, verbose=False, mesh=mesh, steps_per_call=K,
        stats=stats)
    if [c[0] for c in stats["calls"]] != [K]:
        raise RuntimeError(f"dryrun_multichip: calls {stats['calls']}")
    _finite(out[3], "the mean loss of the K-step call")
    print(f"dryrun_multichip({n_devices}) {K} steps over shard_scan_inputs "
          f"OK: one call, mean loss={out[3]:.5f}")

    mlp_fl = nerf.NeRFConfig()
    if "model" in mesh.shape:
        p_tp = nerf.init_params(mlp_fl, g, device=first)
        n_tp = 2048
        pts_e = torch.randn(n_tp, 63, generator=g).to(first)
        views_e = torch.randn(n_tp, 27, generator=g).to(first)
        with torch.no_grad():
            raw_tp = mlp_tp_fused.fused_nerf_mlp_tp(p_tp, pts_e, views_e,
                                                    mesh)
            dense = nerf.apply_mlp(p_tp, pts_e, views_e)
        _finite(raw_tp, "the TP fused MLP's output")
        if not torch.allclose(raw_tp, dense, rtol=1e-4, atol=1e-5):
            raise RuntimeError("dryrun_multichip: the TP fused MLP is off "
                               "the dense MLP (rtol 1e-4, atol 1e-5)")
        print(f"dryrun_multichip({n_devices}) TP fused MLP OK: raw "
              f"{tuple(raw_tp.shape)}")

    render_mesh = parallel.make_mesh(n_devices, ("data",), devices=devices)
    rc_fl = renderer.RenderConfig(mlp=mlp_fl, n_samples=8, n_importance=8,
                                  chunk=32 * n_devices, use_fused_mlp=True,
                                  use_fused_compositing=True,
                                  fusion_ray_tile=32)
    p_fl = nerf.init_params(mlp_fl, g, device=first)
    n_r = 32 * n_devices
    out = renderer.render_image(
        p_fl, p_fl, rng.normal(0, 0.1, (n_r, 3)).astype(np.float32),
        (rng.normal(0, 0.2, (n_r, 3)) - [0, 0, 1]).astype(np.float32),
        2.0, 6.0, rc_fl, mesh=render_mesh)
    _finite(out["rgb_map"], "the mesh render")
    print(f"dryrun_multichip({n_devices}) fused mesh render OK: rgb "
          f"{tuple(out['rgb_map'].shape)}")

    H, W = 4 * n_devices, 16
    Kc = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]],
                  np.float32)
    ro_f, rd_f = get_rays_np(H, W, Kc,
                             synthetic.look_at_poses(1, seed=0)[0][:3, :4])
    grid = occupancy.OccupancyGrid(
        occ=torch.ones((16, 16, 16), dtype=torch.bool, device=first),
        lo=(-2.0,) * 3, hi=(2.0,) * 3)
    rc_occ = renderer.RenderConfig(mlp=mlp_fl, n_samples=8, n_importance=0,
                                   use_fused_mlp=True,
                                   use_fused_compositing=True,
                                   occ_ray_tile=32)
    frame = lambda **kw: occupancy.render_image_fast(
        p_fl, ro_f, rd_f, 2.0, 6.0, rc_occ, grid, n_candidates=16, budget=8,
        subsample=2, row_chunk=H, **kw)["rgb_map"]
    sharded, single = frame(mesh=render_mesh), frame()
    _finite(sharded, "the occupancy mesh frame")
    d_occ = float(np.abs(sharded - single).max())
    if d_occ > 1e-5:
        raise RuntimeError(f"dryrun_multichip: the occupancy mesh frame is "
                           f"{d_occ} off the single-device frame")
    print(f"dryrun_multichip({n_devices}) occupancy mesh frame OK: rgb "
          f"{sharded.shape}, max |d| {d_occ:.1e} from one device")

    if n_devices % 2 == 0 and n_devices > 1:
        S = 2
        scene_mesh = multi_scene.make_scene_mesh(S, n_devices,
                                                 devices=devices)
        n_msr = 8 * (n_devices // S)
        ms_scenes = [{"near": 2.0, "far": 6.0} for _ in range(S)]
        rc_ms = renderer.RenderConfig(mlp=mlp, n_samples=8, n_importance=8)
        g_ms = torch.Generator().manual_seed(20)
        starts = [tuple(nerf.init_params(mlp, g_ms) for _ in range(2))
                  for _ in range(S)]
        on = lambda pair, d: tuple(nerf.init_lsa_scales(
            copy.deepcopy(m).to(d)) for m in pair)
        tuned, psnrs = multi_scene.tune_multi_scene(
            ms_scenes, [on(starts[s], scene_mesh.devices[s, 0])
                        for s in range(S)], rc_ms,
            batchers=[_FakeBatcher(s, n_msr) for s in range(S)], n_iters=2,
            mesh=scene_mesh, verbose=False)
        _finite(psnrs, "the multi-scene PSNRs")
        # the sharded joint run must match scene 0 tuned alone, unsharded,
        # on the same batches and draws (stacked Adam == per-scene Adam)
        seq_tuned, _ = multi_scene.tune_multi_scene(
            ms_scenes[:1], [on(starts[0], first)], rc_ms,
            batchers=[_FakeBatcher(0, n_msr)], n_iters=2, verbose=False,
            seeds=multi_scene.scene_seeds(0, S)[:1])
        for joint_s, seq_s in zip(tuned[0], seq_tuned[0]):
            for name in seq_s:
                if not torch.allclose(joint_s[name].to(first), seq_s[name],
                                      rtol=2e-4, atol=2e-6):
                    raise RuntimeError(f"dryrun_multichip: joint and "
                                       f"sequential scales of {name} differ")
        print(f"dryrun_multichip({n_devices}) multi-scene mesh LSA OK: {S} "
              f"scenes on mesh {scene_mesh.shape}, "
              f"psnrs={[round(p, 2) for p in psnrs]}, joint==sequential "
              f"scales verified")
