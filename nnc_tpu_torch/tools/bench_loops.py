"""The bench's loops call by call: why one frame reads other rates in loops
of other lengths.

    python -m nnc_tpu_torch.tools.bench_loops [--dtype float32]

``nnc_tpu_torch/bench.py`` times each of its loops on the host clock around
between CUDA events after untimed calls (``bench.loop_ms``); it timed
them on the host clock around the whole loop after one untimed call. This
tool takes the bench's
headline frame (the solid teacher's 400x400 frame through its 128^3 grid at
48 / 16 / 4, ``bench._fast``) and its single LSA step on the occupancy loss
(``bench.train_setup``, N_rand 1,024) and prints, in this order:

1. ``cold``: the frame's first ``CALLS`` calls after the call that builds
   the kernels, each on its own: the host clock until the call returns
   (its launches issued, "issue"), and until the synchronize after it
   ("host"), and the device's span between CUDA events around it;
2. ``after_load``: the same after the bench's own load before its frame
   loop (``CALLS`` exact 160x256 renders, then ``CALLS`` fast crops);
3. ``after_idle``: ``IDLE_CALLS`` calls after the card idled ``IDLE_S``;
4. ``loops``: for each length of ``LOOPS`` in turn, the loop timed on the
   host clock after one untimed call (``render_work.wall_ms``) and as the
   bench times it (``bench.loop_ms``), then under ``torch.profiler``: the
   device's busy ms a call and K-B2's (``render_work.kb2_ms``);
5. ``occ_step``: ``CALLS`` single LSA steps, each read back.

On the card an ``nvidia-smi`` sampler runs beside it every ``SAMPLE_MS``
and each part prints the SM clock (MHz) and power draw (W) that it saw.
Each series is printed as its first call, the median of its calls 2-10
and of its last 20 calls, and whole in the JSON line last. The model
computes in ``--dtype`` (bfloat16 by default, as the bench's). On the CPU
(``NNC_TPU_TORCH_DEVICE=cpu``) the device span, the profiler's times and
the clocks are None.
"""
from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import time

import torch

from .. import bench
from ..data import synthetic
from ..models import nerf
from ..render import occupancy, renderer
from ..utils.platform import card_line, device_from_env
from . import render_work

CALLS = 60
IDLE_CALLS, IDLE_S = 10, 1.0
LOOPS = (5, 60)
SAMPLE_MS = 20
SMI_FIELDS = "timestamp,clocks.sm,power.draw"
# one sample line: local time (to the ms), SM MHz, W
SAMPLE = re.compile(r"^(\d{4}/\d\d/\d\d \d\d:\d\d:\d\d)\.(\d+), "
                    r"([\d.]+), ([\d.]+)$")


def series(fn, calls: int, device) -> dict:
    """``calls`` calls of ``fn``, each alone: the host ms until it returns
    and until the synchronize after it and, on the card, the device's ms
    between CUDA events around it; with the host clock's span of the
    series."""
    cuda = torch.device(device).type == "cuda"
    issue, host, dev = [], [], []
    render_work.sync(device)
    start = time.time()
    for _ in range(calls):
        if cuda:
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
            e0.record()
        t0 = time.perf_counter()
        fn()
        issue.append(1e3 * (time.perf_counter() - t0))
        if cuda:
            e1.record()
        render_work.sync(device)
        host.append(1e3 * (time.perf_counter() - t0))
        if cuda:
            dev.append(e0.elapsed_time(e1))
    return {"issue_ms": issue, "host_ms": host,
            "device_ms": dev if cuda else None,
            "span": (start, time.time())}


def summary(ms) -> str:
    """first, median of calls 2-10 and of the last 20 of a series."""
    if not ms:
        return "none"
    return (f"first {ms[0]:.3f}, 2-10 {statistics.median(ms[1:10] or ms):.3f}"
            f", last 20 {statistics.median(ms[-20:]):.3f} ms")


class Sampler:
    """``nvidia-smi`` sampling the SM clock and the power draw every
    ``SAMPLE_MS`` while the block runs (nothing on the CPU)."""

    def __init__(self, device):
        self.on = torch.device(device).type == "cuda"
        self.lines = []

    def __enter__(self):
        if self.on:
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
                 "--format=csv,noheader,nounits", f"-lms={SAMPLE_MS}"],
                stdout=subprocess.PIPE, text=True)
        return self

    def __exit__(self, *_exc):
        if self.on:
            self.proc.terminate()
            out, _ = self.proc.communicate(timeout=60)
            self.lines = [m.groups() for m in map(SAMPLE.match,
                                                  out.splitlines()) if m]
        return False

    def within(self, span):
        """(SM MHz, W) of each sample inside the host clock's ``span``."""
        out = []
        for stamp, frac, mhz, watts in self.lines:
            t = time.mktime(time.strptime(stamp, "%Y/%m/%d %H:%M:%S")) \
                + float("0." + frac)
            if span[0] <= t <= span[1]:
                out.append((float(mhz), float(watts)))
        return out


def clocks(samples) -> str:
    if not samples:
        return "clock not sampled"
    mhz = [s[0] for s in samples]
    watts = [s[1] for s in samples]
    return (f"SM {min(mhz):.0f}-{max(mhz):.0f} MHz (median "
            f"{statistics.median(mhz):.0f}), {min(watts):.0f}-"
            f"{max(watts):.0f} W, {len(samples)} samples")


@torch.no_grad()
def frame_parts(cfg, device, *, frame_hw=bench.FRAME_HW,
                crop_hw=bench.CROP_HW, res: int = 128, calls: int = CALLS,
                loops=LOOPS, idle_s: float = IDLE_S) -> dict:
    """Parts 1-4 of the module's doc on the bench's frame."""
    model_c = synthetic.make_solid_mlp(cfg, device=device)
    model_f = synthetic.make_solid_mlp(cfg, device=device)
    H, W = crop_hw
    rc = bench.render_config(cfg, H * W)
    grid = occupancy.build_occupancy_grid(model_c, res=res)
    ro, rd = render_work.frame_rays(*frame_hw, device)
    frame = lambda _i=0: bench._fast(model_f, ro, rd, grid, rc, frame_hw)
    cro, crd = render_work.frame_rays(H, W, device)
    out = {}
    frame()
    out["cold"] = series(frame, calls, device)
    for _ in range(calls):
        renderer.render_chunk(model_c, model_f, cro, crd, bench.NEAR,
                              bench.FAR, rc, True)
    for _ in range(calls):
        bench._fast(model_f, cro, crd, grid, rc, crop_hw)
    out["after_load"] = series(frame, calls, device)
    render_work.sync(device)
    time.sleep(idle_s)
    out["after_idle"] = series(frame, IDLE_CALLS, device)
    out["loops"] = []
    for n in loops:
        t0 = time.time()
        frame()
        wall = render_work.wall_ms(frame, n, device)
        timed = bench.loop_ms(frame, n, device)
        kb2 = render_work.kb2_ms(frame, n, device)
        out["loops"].append({"n": n, "wall_ms": wall, "bench_ms": timed,
                             "busy_ms": kb2["busy_ms"],
                             "kb2_ms": kb2["kb2_ms"],
                             "span": (t0, time.time())})
    return out


def occ_step_series(cfg, device, *, n: int = 1024, res: int = 128,
                    calls: int = CALLS) -> dict:
    """Part 5: single LSA steps on the occupancy loss, each read back."""
    grid = occupancy.build_occupancy_grid(
        synthetic.make_solid_mlp(cfg, device=device), res=res, dilate=1)
    _models, _adam, step, rc = bench.train_setup(cfg, device, grid)
    batch = bench.train_batch(n, device)
    draws = bench.train_draws(n, rc, device, grid)
    hyper = bench._hypers(calls + 1, device)
    it = iter(range(calls + 1))
    one = lambda: float(step(batch, draws, hyper[next(it)])[0])
    one()
    return series(one, calls, device)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=sorted(render_work.DTYPES),
                    default="bfloat16")
    args = ap.parse_args(argv)
    device = device_from_env()
    print(card_line(device), flush=True)
    cfg = nerf.NeRFConfig(compute_dtype=render_work.DTYPES[args.dtype])
    with Sampler(device) as smi:
        parts = frame_parts(cfg, device)
        parts["occ_step"] = occ_step_series(cfg, device)
    rays = bench.FRAME_HW[0] * bench.FRAME_HW[1]
    for name in ("cold", "after_load", "after_idle", "occ_step"):
        s = parts[name]
        print(f"{name} ({args.dtype}): issue {summary(s['issue_ms'])}; host "
              f"{summary(s['host_ms'])}; device {summary(s['device_ms'])}; "
              f"{clocks(smi.within(s['span']))}")
    for lp in parts["loops"]:
        busy = "" if lp["busy_ms"] is None else \
            f", device busy {lp['busy_ms']:.3f} ms a call"
        rate = lambda ms: f"{ms:.3f} ms ({rays / ms / 1e3:.1f} M rays/s)"
        print(f"loop of {lp['n']} ({args.dtype}): host clock after one call "
              f"{rate(lp['wall_ms'])} a call, bench.loop_ms "
              f"{rate(lp['bench_ms'])}{busy}, K-B2 {lp['kb2_ms']:.3f} ms; "
              f"{clocks(smi.within(lp['span']))}")
    line = {"dtype": args.dtype, **parts}
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
