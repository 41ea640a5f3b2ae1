"""The stages of occupancy mode's 400x400 frame on the card.

    python -m nnc_tpu_torch.tools.profile_fast_frame [--dtype float32]
        [--iters 20] [--candidates 48] [--budget 16] [--subsample 4]

Counterpart of ``tools/profile_fast_frame.py``. The scene is a 400x400
frame (``render_work.frame_rays``) of the solid teacher through its 128^3
grid (built through K-B3), rendered as ``occupancy.render_rays_fast`` renders
a camera frame (``_render_tiled_sorted``). Cumulative probes, each timed on
the host clock around calls that end in a synchronize:

1. ``select``: ``occupancy._select_sub`` (the sweep of the subsampled
   raster and the compaction to the budget);
2. ``presort``: that, and the blocks sorted by their occupied count, every
   ray placed at its block's row by arithmetic, and gather #1 (the packed
   rays);
3. ``full``: ``render_rays_fast`` (the above, K-B2, gather #2 of the packed
   maps and the white background);
4. ``frame``: ``render_image_fast`` on the host arrays, the frame's rays in
   and its four maps out, as chip_smoke.py phase 20 times a frame;

and beside them K-B2's own time inside ``full`` (its kernel's device time
under ``torch.profiler``, with the device's busy time a frame; on the CPU
the host clock around its plain version), gather #2 alone on the frame's
packed (R, 5) maps, and the reference's isolated (R + 128, 128) maps
gather. The rest of ``full`` less ``presort`` and K-B2 is what the launch's
producer (dists scaled by |rays_d|, the live flags), gather #2 and the
background take. The model computes in ``--dtype`` (bfloat16 by default, as the
reference's). The device is the one ``NNC_TPU_TORCH_DEVICE`` names, else the
first CUDA device; the first call of each probe builds the kernels and is
not timed.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from . import render_work

HW = (400, 400)
NEAR, FAR = 2.0, 6.0
PROBES = ("select", "presort", "full", "frame")


def _probes(model, grid, rays_o, rays_d, vd, rc, layout, C, B, fac):
    """The cumulative probes by name, in order (see the module's doc)."""
    from ..render import occupancy
    H, W = layout
    Ws = W // fac
    nb = fac * fac

    def select():
        z_s, dists_s, _any = occupancy._select_sub(
            grid, rays_o, rays_d, NEAR, FAR, C, B, layout, fac)
        return z_s + dists_s

    def presort():
        z_s, dists_s, _any = occupancy._select_sub(
            grid, rays_o, rays_d, NEAR, FAR, C, B, layout, fac)
        counts = (dists_s > 0).sum(dim=-1, dtype=torch.int32)
        order_s = torch.argsort(-counts, stable=True)
        pos_s = torch.argsort(order_s)
        by, bx = order_s // Ws, order_s % Ws
        ar = torch.arange(fac, device=rays_o.device)
        offs = (ar[:, None] * W + ar[None, :]).reshape(-1)
        ray_idx = ((by * fac * W + bx * fac)[:, None] + offs[None, :]) \
            .reshape(-1)
        rays9_s = torch.cat([rays_o, rays_d, vd], dim=1)[ray_idx]
        z_sorted = z_s[order_s].repeat_interleave(nb, dim=0)
        return rays9_s[:, 0] + z_sorted[:, 0] + pos_s[0].float()

    def full():
        return occupancy.render_rays_fast(
            model, rays_o, rays_d, vd, NEAR, FAR, grid, rc, n_candidates=C,
            budget=B, layout=layout, subsample=fac)

    ro_h = rays_o.reshape(H, W, 3).cpu().numpy()
    rd_h = rays_d.reshape(H, W, 3).cpu().numpy()

    def frame():
        return occupancy.render_image_fast(
            model, ro_h, rd_h, NEAR, FAR, rc, grid, n_candidates=C, budget=B,
            subsample=fac)

    return {"select": select, "presort": presort, "full": full,
            "frame": frame}


@torch.no_grad()
def profile(model, grid, rays_o, rays_d, layout, *, candidates: int = 48,
            budget: int = 16, subsample: int = 4, iters: int = 20) -> dict:
    """Milliseconds of each probe of :data:`PROBES` (one untimed call first,
    in this order), of K-B2 inside ``full`` ("kb2", with "busy" the
    device's busy ms a frame, None on the CPU), of gather #2 alone on
    the frame's packed maps ("gather2") and of the reference's (R + 128,
    128) maps gather ("gather2_128"); "order" lists the probes as they
    ran."""
    from ..render import renderer
    device = rays_o.device
    R = rays_o.shape[0]
    rc = renderer.RenderConfig(
        mlp=model.config, n_samples=64, n_importance=128, white_bkgd=True,
        chunk=40960, use_fused_mlp=True, use_fused_compositing=True,
        early_term_eps=1e-4, empty_ray_eps=1e-3)
    vd = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    probes = _probes(model, grid, rays_o, rays_d, vd, rc, layout,
                     candidates, budget, subsample)
    out = {"order": []}
    for name in PROBES:
        probes[name]()
        out[name] = render_work.wall_ms(probes[name], iters, device)
        out["order"].append(name)
    # K-B2 inside the full frame, and the device's busy time in it
    kb2 = render_work.kb2_ms(probes["full"], iters, device)
    out["kb2"], out["busy"] = kb2["kb2_ms"], kb2["busy_ms"]
    out["kb2_launches"] = kb2["launches"]
    # gather #2 alone: the kernel's packed maps taken back to raster order
    maps = torch.zeros(R, 5, device=device)
    k = torch.as_tensor(np.random.default_rng(0).permutation(R), device=device)
    gather = lambda m=maps: m[k]
    gather()
    out["gather2"] = render_work.wall_ms(gather, iters, device)
    maps128 = torch.zeros(R + 128, 128, device=device)
    gather128 = lambda: maps128[k].sum()
    gather128()
    out["gather2_128"] = render_work.wall_ms(gather128, iters, device)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--subsample", type=int, default=4)
    ap.add_argument("--candidates", type=int, default=48)
    ap.add_argument("--budget", type=int, default=16)
    ap.add_argument("--hw", type=int, nargs=2, default=HW)
    ap.add_argument("--dtype", choices=sorted(render_work.DTYPES),
                    default="bfloat16")
    args = ap.parse_args(argv)

    from ..data.synthetic import make_solid_mlp
    from ..models import nerf
    from ..render import occupancy
    from ..utils.platform import device_from_env

    device = device_from_env()
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"device: {device} ({name}), dtype {args.dtype}")
    mlp = nerf.NeRFConfig(compute_dtype=render_work.DTYPES[args.dtype])
    model = make_solid_mlp(mlp, device=device)
    grid = occupancy.build_occupancy_grid(make_solid_mlp(mlp, device=device),
                                          res=128)
    H, W = args.hw
    ro, rd = render_work.frame_rays(H, W, device)
    C, B, fac = args.candidates, args.budget, args.subsample
    t = profile(model, grid, ro, rd, (H, W), candidates=C, budget=B,
                subsample=fac, iters=args.iters)
    rest = t["full"] - t["presort"] - t["kb2"]
    print(f"frame {H}x{W}  C={C} B={B} sub={fac}  iters={args.iters}")
    print(f"  select_sub (sweep+compact):    {t['select']:7.2f} ms")
    print(f"  + sort/expand/gather#1:        {t['presort']:7.2f} ms "
          f"(delta {t['presort'] - t['select']:+.2f})")
    print(f"  full frame (render_rays_fast): {t['full']:7.2f} ms "
          f"(delta {t['full'] - t['presort']:+.2f} = "
          f"producer+kernel+gather#2)")
    busy = "" if t["busy"] is None else \
        f"; the device busy {t['busy']:.2f} ms of it"
    print(f"    K-B2 inside it:              {t['kb2']:7.2f} ms "
          f"({t['kb2_launches']:g} launch a frame); the rest {rest:+.2f} ms"
          f"{busy}")
    print(f"  render_image_fast (host in/out): {t['frame']:5.2f} ms "
          f"(delta {t['frame'] - t['full']:+.2f})")
    print(f"  maps gather#2 alone, (R, 5):   {t['gather2']:7.2f} ms; the "
          f"reference's (R+128, 128) probe {t['gather2_128']:.2f} ms")
    print(f"  => rays/s: {H * W / (t['full'] / 1e3) / 1e6:.2f}M")
    return t


if __name__ == "__main__":
    main()
