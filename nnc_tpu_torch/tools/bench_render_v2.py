"""The route ladder of the exact render on the card: plain MLP, fused MLP,
fused render pass without and with early termination.

    python -m nnc_tpu_torch.tools.bench_render_v2 [--dtype float32]
        [--chunk 8192] [--iters 10] [--check]

Counterpart of ``tools/bench_render_v2.py``. The scene is a 64x128 frame
(``render_work.frame_rays``) of the solid teacher (``make_solid_mlp``, the
same network coarse and fine) at 64 + 128 samples, near 2, far 6, white
background, all of the frame's rays in one chunk of ``--chunk``. The routes
of ``renderer.render_chunk``:

- ``plain``: the plain MLP and ``raw2outputs`` (timed only with
  ``--check``, as in the reference);
- ``fused_mlp``: K-B3 from points, then ``raw2outputs``;
- ``fused_noet``: K-B2 for both passes, early termination and empty-ray
  culling off;
- ``fused_et_64x32``: K-B2 with early termination at 1e-4 and culling at
  1e-3 in culling groups of ``fusion_ray_tile`` = 64 rays (the kernel's own
  tile stays ``render_fused.RAY_TILE``).

It prints rays/s and ms a chunk for each route and, for the K-B2 routes, the
points each launch computed against the points its rays need
(``render_work.kb2_points``); with ``--check`` also each route's max / mean
deviation from the plain route and the frame's active-ray fraction (acc >
1e-3 in the plain render). The model computes in ``--dtype``
(bfloat16 by default, as the reference's). The device is the one
``NNC_TPU_TORCH_DEVICE`` names, else the first CUDA device; the first call
of each route builds the kernels and is not timed.
"""
from __future__ import annotations

import argparse
import time

import torch

from . import render_work

ROUTES = ("plain", "fused_mlp", "fused_noet", "fused_et_64x32")
HW = (64, 128)
NEAR, FAR = 2.0, 6.0


def route_configs(mlp, chunk: int, n_samples: int = 64,
                  n_importance: int = 128) -> dict:
    """The four routes' RenderConfigs, by name."""
    from ..render import renderer
    rc = lambda **kw: renderer.RenderConfig(
        mlp=mlp, n_samples=n_samples, n_importance=n_importance,
        white_bkgd=True, chunk=chunk, **kw)
    return {"plain": rc(),
            "fused_mlp": rc(use_fused_mlp=True),
            "fused_noet": rc(use_fused_mlp=True, use_fused_compositing=True,
                             early_term_eps=0.0, empty_ray_eps=0.0),
            "fused_et_64x32": rc(use_fused_mlp=True,
                                 use_fused_compositing=True,
                                 early_term_eps=1e-4, empty_ray_eps=1e-3,
                                 fusion_ray_tile=64, fusion_sample_block=32)}


@torch.no_grad()
def measure(model_c, model_f, rays_o, rays_d, *, iters: int = 10,
            check: bool = False, n_samples: int = 64,
            n_importance: int = 128) -> dict:
    """Each route on (rays_o, rays_d), one chunk: {route: {"ms",
    "rays_per_s", "first_s", "points": [(S, needed, computed) per K-B2
    launch of the first call]}}; with ``check`` each fused route also gets
    "maxdev", "meandev" against the plain route's rgb, and
    "active_fraction" the share of rays whose plain acc exceeds 1e-3.
    The plain route runs only with ``check``."""
    from ..render import renderer
    device = rays_o.device
    n = rays_o.shape[0]
    out, rgb = {}, {}
    for name, rc in route_configs(model_c.config, n, n_samples,
                                  n_importance).items():
        if name == "plain" and not check:
            continue
        run = lambda rc=rc: renderer.render_chunk(
            model_c, model_f, rays_o, rays_d, NEAR, FAR, rc, True)
        calls = []
        t0 = time.perf_counter()
        with render_work.kb2_launches(calls):
            first = run()
        render_work.sync(device)
        res = {"first_s": time.perf_counter() - t0}
        rgb[name] = first["rgb_map"].float().cpu().numpy()
        if name == "plain":
            out["active_fraction"] = float(
                (first["acc_map"] > 1e-3).float().mean())
        res["points"] = [(a[4].shape[1], *render_work.kb2_points(k, a))
                         for k, a, _kw in calls]
        res["ms"] = render_work.wall_ms(run, iters, device)
        res["rays_per_s"] = n / (res["ms"] / 1e3)
        out[name] = res
    if check:
        for name in ROUTES[1:]:
            d = render_work.deviation(rgb[name], rgb["plain"])
            out[name].update(maxdev=d["maxdev"], meandev=d["meandev"])
    return out


def _points_line(points) -> str:
    """``[(samples, needed, computed), ...]`` as the tool prints it."""
    if not points:
        return "no K-B2 launch"
    return "K-B2 points needed / computed: " + ", ".join(
        f"S={S} {n:,} / {c:,} ({c / max(n, 1):.2f}x)" for S, n, c in points)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunk", type=int, default=8192)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--dtype", choices=sorted(render_work.DTYPES),
                    default="bfloat16")
    ap.add_argument("--hw", type=int, nargs=2, default=HW,
                    help="frame height and width (default 64 128)")
    args = ap.parse_args(argv)

    from ..data.synthetic import make_solid_mlp
    from ..models import nerf
    from ..utils.platform import device_from_env

    device = device_from_env()
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"device: {device} ({name}), dtype {args.dtype}")
    mlp = nerf.NeRFConfig(compute_dtype=render_work.DTYPES[args.dtype])
    model_c = make_solid_mlp(mlp, device=device)
    model_f = make_solid_mlp(mlp, device=device)
    ro, rd = render_work.frame_rays(*args.hw, device)
    ro, rd = ro[:args.chunk], rd[:args.chunk]
    res = measure(model_c, model_f, ro, rd, iters=args.iters,
                  check=args.check)
    for route in ROUTES:
        if route not in res:
            continue
        r = res[route]
        print(f"{route}: compile+1st {r['first_s']:.1f}s; "
              f"{r['rays_per_s']:,.0f} rays/s  ({r['ms']:.2f} ms/chunk); "
              + _points_line(r["points"]))
    if args.check:
        for route in ROUTES[1:]:
            print(f"{route} vs plain: max {res[route]['maxdev']:.5f} mean "
                  f"{res[route]['meandev']:.6f}")
        print(f"active-ray fraction (acc>1e-3): "
              f"{res['active_fraction']:.3f}")
    return res


if __name__ == "__main__":
    main()
