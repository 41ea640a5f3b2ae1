"""Occupancy mode's operating points on the card: speed, and deviation from
the exact render.

    python -m nnc_tpu_torch.tools.tune_fast_mode [--dtype float32]
        [--iters 20] [--hw 160 256] [--floor] [--no-exact]
        [--points C:B:sub,...]

Counterpart of ``tools/tune_fast_mode.py``. The scene is a 160x256 frame
(``render_work.frame_rays``) of the solid teacher (``make_solid_mlp``, the
same network coarse and fine), a 128^3 grid built from the coarse network
through K-B3 (``occupancy.build_occupancy_grid``), and the exact frame
through K-B2 (64 + 128 samples, early termination at 1e-4, culling at 1e-3,
white background, one chunk). For each point (C candidates, budget B,
subsample) the fine network renders the frame in occupancy mode
(``occupancy.render_rays_fast`` on the frame's layout, through K-B2), and
the tool prints its ms and rays/s, its max |rgb deviation| and devPSNR
(-10 log10(mean dev^2)) against the exact frame, and the points K-B2
computed against the points the compacted rays need
(``render_work.kb2_points``). ``--floor`` also times each point on an empty
grid; ``--no-exact`` skips the exact frame (times only).

The reference's points carry two more fields, ``s_blk`` and ``r_t``
(``occ_sample_block`` / ``occ_ray_tile``): the TPU kernel's tiles, which the
port's K-B2 does not take (it culls at its own ray tile). The tool accepts
them, warns once, and merges points that differ only in them; its default
points are the four distinct (C, B, sub) of the reference's six. The model
computes in ``--dtype`` (bfloat16 by default, as the reference's). The
device is the one ``NNC_TPU_TORCH_DEVICE`` names, else the first CUDA
device; the first call of each render builds the kernels and is not timed.
"""
from __future__ import annotations

import argparse
import warnings

import torch

from . import render_work

# the reference's six points, (C, B, sub, s_blk, r_t), less the TPU tiles
DEFAULT_POINTS = ((64, 16, 4), (96, 48, 4), (64, 16, 8), (96, 16, 4))
HW = (160, 256)
NEAR, FAR = 2.0, 6.0


def parse_points(spec):
    """``C:B:sub[:s_blk[:r_t]]`` points, comma-separated, as distinct (C, B,
    sub) in their first order; warns once where a point names s_blk / r_t.
    None gives :data:`DEFAULT_POINTS`."""
    if spec is None:
        return list(DEFAULT_POINTS)
    points, tiles = [], False
    for item in spec.split(","):
        fields = [int(x) for x in item.split(":")]
        if not 3 <= len(fields) <= 5:
            raise ValueError(f"point {item!r}: expected C:B:sub[:s_blk[:r_t]]")
        tiles |= len(fields) > 3
        if tuple(fields[:3]) not in points:
            points.append(tuple(fields[:3]))
    if tiles:
        warnings.warn("s_blk / r_t (occ_sample_block / occ_ray_tile) are the "
                      "TPU kernel's tiles, which the port's K-B2 does not "
                      "take: points that differ only in them are merged",
                      stacklevel=2)
    return points


@torch.no_grad()
def sweep(model_c, model_f, grid, rays_o, rays_d, layout, points, *,
          iters: int = 20, floor: bool = False, exact: bool = True,
          n_samples: int = 64, n_importance: int = 128) -> dict:
    """The exact frame (unless ``exact`` is False) and each (C, B, sub) of
    ``points`` through ``grid``: {"occupied_fraction", "exact": {"ms",
    "rays_per_s"}, "points": [{"C", "B", "sub", "ms", "rays_per_s",
    "needed", "computed"[, "maxdev", "dev_psnr"][, "floor_ms"]}]}."""
    from ..render import occupancy, renderer
    device = rays_o.device
    n = rays_o.shape[0]
    rc = renderer.RenderConfig(
        mlp=model_f.config, n_samples=n_samples, n_importance=n_importance,
        white_bkgd=True, chunk=n, use_fused_mlp=True,
        use_fused_compositing=True, early_term_eps=1e-4, empty_ray_eps=1e-3)
    vd = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    out = {"occupied_fraction": float(grid.occ.float().mean()),
           "points": []}
    ref = None
    if exact:
        run_exact = lambda: renderer.render_chunk(
            model_c, model_f, rays_o, rays_d, NEAR, FAR, rc, True)
        ref = run_exact()["rgb_map"].float().cpu().numpy()
        ms = render_work.wall_ms(run_exact, iters, device)
        out["exact"] = {"ms": ms, "rays_per_s": n / (ms / 1e3)}
    empty = occupancy.OccupancyGrid(occ=torch.zeros_like(grid.occ),
                                    lo=grid.lo, hi=grid.hi)
    for C, B, sub in points:
        run = lambda g=grid, C=C, B=B, sub=sub: occupancy.render_rays_fast(
            model_f, rays_o, rays_d, vd, NEAR, FAR, g, rc, n_candidates=C,
            budget=B, layout=layout, subsample=sub)
        row = {"C": C, "B": B, "sub": sub}
        if floor:
            run(empty)
            row["floor_ms"] = render_work.wall_ms(lambda: run(empty), iters,
                                                  device)
        calls = []
        with render_work.kb2_launches(calls):
            fast = run()
        counts = [render_work.kb2_points(k, a) for k, a, _kw in calls]
        row["needed"] = sum(c[0] for c in counts)
        row["computed"] = sum(c[1] for c in counts)
        if ref is not None:
            d = render_work.deviation(fast["rgb_map"].float().cpu().numpy(),
                                      ref)
            row.update(maxdev=d["maxdev"], dev_psnr=d["dev_psnr"])
        row["ms"] = render_work.wall_ms(run, iters, device)
        row["rays_per_s"] = n / (row["ms"] / 1e3)
        out["points"].append(row)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--hw", type=int, nargs=2, default=HW)
    ap.add_argument("--floor", action="store_true")
    ap.add_argument("--no-exact", action="store_true",
                    help="skip the exact reference render: timing only")
    ap.add_argument("--points", type=str, default=None,
                    help="comma list of C:B:sub[:s_blk[:r_t]] tuples, "
                         "e.g. 96:48:4,96:24:4:8 (s_blk / r_t are ignored)")
    ap.add_argument("--dtype", choices=sorted(render_work.DTYPES),
                    default="bfloat16")
    args = ap.parse_args(argv)
    points = parse_points(args.points)

    from ..data.synthetic import make_solid_mlp
    from ..models import nerf
    from ..render import occupancy
    from ..utils.platform import device_from_env

    device = device_from_env()
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"device: {device} ({name}), dtype {args.dtype}")
    mlp = nerf.NeRFConfig(compute_dtype=render_work.DTYPES[args.dtype])
    model_c = make_solid_mlp(mlp, device=device)
    model_f = make_solid_mlp(mlp, device=device)
    H, W = args.hw
    ro, rd = render_work.frame_rays(H, W, device)
    grid = occupancy.build_occupancy_grid(model_c, res=128)
    res = sweep(model_c, model_f, grid, ro, rd, (H, W), points,
                iters=args.iters, floor=args.floor, exact=not args.no_exact)
    if "exact" in res:
        e = res["exact"]
        print(f"exact: {e['ms']:7.2f} ms  ({e['rays_per_s']:,.0f} rays/s)")
    print(f"grid occupied fraction: {res['occupied_fraction']:.4f}")
    for p in res["points"]:
        head = f"C={p['C']:3d} B={p['B']:2d} sub={p['sub']}"
        if "floor_ms" in p:
            print(f"{head} FLOOR(empty grid): {p['floor_ms']:7.2f} ms")
        qual = f"  maxdev {p['maxdev']:.4f}  devPSNR {p['dev_psnr']:.1f} dB" \
            if "maxdev" in p else ""
        ratio = p["computed"] / max(p["needed"], 1)
        print(f"{head}: {p['ms']:7.2f} ms  ({p['rays_per_s']:,.0f} rays/s)"
              f"{qual}  K-B2 points needed / computed {p['needed']:,} / "
              f"{p['computed']:,} ({ratio:.2f}x)", flush=True)
    return res


if __name__ == "__main__":
    main()
