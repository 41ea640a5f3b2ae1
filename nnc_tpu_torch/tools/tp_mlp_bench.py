"""Tensor against data parallelism for the fused MLP, measured on one card.

    python -m nnc_tpu_torch.tools.tp_mlp_bench [n_points] [--dtype float32]
        [--device cpu]

The port's counterpart of ``tools/tp_mlp_bench.py``. One card cannot show
what the sums over shards cost, so this times the part that comes first:
M-way tensor parallelism can beat M-way data parallelism only if one
shard's forward (its five K-B6 pair calls and the replicated torch pieces,
with the sum over shards as the identity) takes less than K-B5 over the
full width takes for 1 / M of the points. For M = 1, 2, 4 it prints that
shard's time beside K-B5's time / M: a measurement, with no verdict.

The model is the flagship architecture in ``NeRFConfig(compute_dtype=...)``,
bfloat16 by default as in the reference, its weights random from
``torch.Generator`` seed 0 (``nerf.init_params``), its LSA scales absent;
the embeddings (n, 63) and (n, 27) are N(0, 1) from seed 1. It runs on
``cuda:0`` unless ``--device`` says otherwise; there it first prints the
card's name and power limit and times with CUDA events over ``ITERS`` = 10
calls after two warm-ups, as the reference times 10 calls. With
``--device cpu`` it times the kernels' plain versions on the host clock.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..models import nerf
from ..ops import _build, mlp_fused, mlp_tp_fused
from ..utils.device import require_cuda
from ..utils.platform import card_line

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
SHARDS = (1, 2, 4)
ITERS = 10


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=262144,
                    help="points (default 262,144)")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bfloat16")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the kernels), cuda:<i>, or cpu "
                         "(their plain versions)")
    return ap


def timed_ms(fn, device):
    """Mean milliseconds of fn() over ``ITERS`` calls after two warm-ups."""
    for _ in range(2):
        fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(ITERS):
            fn()
        return 1e3 * (time.perf_counter() - t0) / ITERS
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / ITERS


def main(argv=None):
    """Prints the lines above; returns {"n", "dtype", "device", "kb5_ms",
    "shard_ms": {M: ms}, "launches": kernel launches of the run}."""
    args = build_parser().parse_args(argv)
    dtype = DTYPES[args.dtype]
    if args.device == "cpu":
        device = torch.device("cpu")
    else:
        device = require_cuda() if args.device == "cuda" \
            else torch.device(args.device)
        print(card_line())
        torch.backends.cuda.matmul.allow_tf32 = False
    model = nerf.init_params(nerf.NeRFConfig(compute_dtype=dtype),
                             torch.Generator().manual_seed(0)).to(device)
    g = torch.Generator().manual_seed(1)
    pe = torch.randn(args.n, 63, generator=g).to(device)
    ve = torch.randn(args.n, 27, generator=g).to(device)
    alone = lambda parts, devices: {devices[0]: parts[0]}
    before = _build.launch_counts()
    print(f"device={device} n={args.n} dtype={args.dtype}")
    out = {"n": args.n, "dtype": args.dtype, "device": str(device),
           "shard_ms": {}}
    with torch.no_grad():
        kb5 = out["kb5_ms"] = timed_ms(
            lambda: mlp_fused.fused_nerf_mlp(model, pe, ve), device)
        print(f"K-B5 over the full width (one call): {kb5:8.3f} ms "
              f"({args.n / kb5 / 1e3:.2f} Mpts/s)")
        for m in SHARDS:
            shards, reps = mlp_tp_fused.place_tp_weights(model, [device] * m,
                                                         dtype)
            ms = out["shard_ms"][m] = timed_ms(
                lambda: mlp_tp_fused._tp_forward({device: (pe, ve)},
                                                 shards[:1], reps,
                                                 psum=alone),
                device)
            print(f"TP shard M={m} (5 pair calls + the replicated torch "
                  f"pieces, no sum over shards): {ms:8.3f} ms; K-B5 / {m} = "
                  f"{kb5 / m:.3f} ms")
    after = _build.launch_counts()
    out["launches"] = {k: after[k] - before[k] for k in after
                       if after[k] != before[k]}
    return out


if __name__ == "__main__":
    main()
