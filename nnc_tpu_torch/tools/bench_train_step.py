"""LSA train-step time of a bf16 model: the plain MLP against K-B1.

    python -m nnc_tpu_torch.tools.bench_train_step [--n_rand 1024]
        [--iters 20] [--with_dw] [--dtype float32] [--device cpu]

The port's counterpart of ``tools/bench_train_step.py``: both networks are
``make_solid_mlp`` in ``NeRFConfig(compute_dtype=torch.bfloat16)`` (with
``--dtype float32``, the reference's float32 configuration), their
LSA scales start at one, and a step renders 64 + 128 samples along each of
``n_rand`` rays (origins N(0, 0.1^2), directions N(0, 0.2^2) + (0, 0, -1),
targets U(0, 1), near 2, far 6), takes the double MSE loss, its backward
and one Adam step (lr 1e-4) on the scales. As in the reference, every step
takes the same batch and the same random draws (the reference passes the
same key to every step); they come from ``torch.Generator`` seed 0, so the
numbers are the reference's recipe, not its values. ``--with_dw`` has the
kernel pair compute the weights' gradient too, which the step drops, as the
reference's does.

For the plain path (``use_fused_train`` off: the plain bf16 MLP, the scale
folded into the weight before rounding) and the fused path (K-B1's bf16
kernels on CUDA, their plain versions on the CPU) it prints one line: ms a
step on the host clock over ``--iters`` steps after a first one, each ending
in ``torch.cuda.synchronize`` on CUDA, rays/s, the final loss and the first
three scales of the coarse network's first layer. It runs on CUDA unless
``--device cpu`` is given; on CUDA it first prints the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..data import synthetic
from ..models import nerf
from ..ops import _build
from ..render import renderer
from ..train import lsa
from ..utils.device import require_cuda
from ..utils.platform import card_line

NEAR, FAR = 2.0, 6.0
LR = 1e-4


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_rand", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--with_dw", action="store_true")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=("bfloat16", "float32"),
                    help="the networks' compute type")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the kernels) or cpu (their "
                         "plain versions)")
    ap.add_argument("--n_samples", type=int, default=64)
    ap.add_argument("--n_importance", type=int, default=128)
    return ap


def batch(n: int, device):
    """The ray batch of every step: (rays_o, rays_d, viewdirs, target)."""
    g = torch.Generator().manual_seed(0)
    ro = 0.1 * torch.randn(n, 3, generator=g)
    rd = 0.2 * torch.randn(n, 3, generator=g) + torch.tensor([0.0, 0.0, -1.0])
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    tgt = torch.rand(n, 3, generator=g)
    return tuple(t.to(device) for t in (ro, rd, vd, tgt))


def run(use_fused: bool, args, device, rays, draws):
    """``args.iters`` steps after a first one; returns a dict of the path's
    numbers (step ms, rays/s, first step s, final loss, ls[0][:3], the
    kernel launches of the timed steps)."""
    mlp = nerf.NeRFConfig(compute_dtype=getattr(torch, args.dtype))
    models = [nerf.init_lsa_scales(synthetic.make_solid_mlp(mlp,
                                                            device=device))
              for _ in range(2)]
    rc = renderer.RenderConfig(mlp=mlp, n_samples=args.n_samples,
                               n_importance=args.n_importance,
                               use_fused_train=use_fused,
                               train_with_dw=args.with_dw)
    trained = lsa.trained_tensors(*models)
    optimizer = torch.optim.Adam(trained, lr=LR, betas=lsa.BETAS,
                                 eps=lsa.EPS)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def step():
        optimizer.zero_grad(set_to_none=True)
        loss, _ = lsa.double_mse_loss(*models, *rays, NEAR, FAR, rc,
                                      draws=draws)
        loss.backward()
        optimizer.step()
        return loss

    t0 = time.perf_counter()
    loss = step()
    sync()
    first = time.perf_counter() - t0
    before = _build.launch_counts()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        loss = step()
    sync()
    dt = (time.perf_counter() - t0) / max(args.iters, 1)
    after = _build.launch_counts()
    ls0 = models[0].pts_linears[0].weight_scaling.detach().reshape(-1)[:3]
    return {"ms": 1e3 * dt, "rays_per_s": args.n_rand / dt,
            "first_s": first, "loss": float(loss.detach()),
            "ls0": ls0.cpu().tolist(),
            "launches": {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}}


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.device == "cpu":
        device = torch.device("cpu")
    else:
        device = require_cuda() if args.device == "cuda" \
            else torch.device(args.device)
        print(card_line())
        torch.backends.cuda.matmul.allow_tf32 = False
    rays = batch(args.n_rand, device)
    rc = renderer.RenderConfig(n_samples=args.n_samples,
                               n_importance=args.n_importance)
    draws = renderer.step_draws(
        args.n_rand, rc, torch.Generator(device=device).manual_seed(0),
        device)
    out = {}
    for name, use_fused in (("plain", False), ("fused", True)):
        r = out[name] = run(use_fused, args, device, rays, draws)
        print(f"{name}: first step {r['first_s']:.1f} s; "
              f"{r['ms']:7.2f} ms/it ({r['rays_per_s']:,.0f} rays/s) "
              f"final loss {r['loss']:.5f} ls[0][:3]="
              f"{[round(v, 7) for v in r['ls0']]}"
              + (f" launches {r['launches']}" if r["launches"] else ""))
    return out


if __name__ == "__main__":
    main()
