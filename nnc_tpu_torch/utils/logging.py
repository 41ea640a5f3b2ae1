"""Metrics + result.txt logging.

The reference rewrites ``result.txt`` in full every iteration with the format
``psnr : [..]\nloss : [..]`` (reference: run_nerf_helpers.py:185-212). We keep
the file format byte-compatible but flush every ``flush_every`` iterations
(O(n) amortized instead of O(n^2)).
"""
from __future__ import annotations

import math
import os
import time
from contextlib import contextmanager


def img2mse(x, y):
    """Mean squared error of two torch tensors or two numpy arrays."""
    return ((x - y) ** 2).mean()


def mse2psnr(mse: float) -> float:
    if mse <= 0:
        return float("inf")
    return -10.0 * math.log10(mse)


def to8b(x):
    import numpy as np
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


class ResultLogger:
    """Accumulates per-iteration psnr/loss; writes reference-format
    result.txt."""

    def __init__(self, basedir: str, flush_every: int = 100):
        self.basedir = basedir
        self.path = os.path.join(basedir, "result.txt")
        os.makedirs(basedir, exist_ok=True)
        self.psnr, self.loss = [], []
        self.flush_every = flush_every

    def append(self, psnr_value: float, loss_value: float):
        self.psnr.append(psnr_value)
        self.loss.append(loss_value)
        if len(self.psnr) % self.flush_every == 0:
            self.flush()

    def flush(self):
        with open(self.path, "w") as f:
            f.write(f"psnr : {self.psnr}\n")
            f.write(f"loss : {self.loss}\n")


def read_result_file(path: str):
    """Parse a result.txt back into (psnr list, loss list)."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            key, val = line.split(":", 1)
            out[key.strip()] = [float(x) for x in
                                val.strip().strip("[]").split(",") if x.strip()]
    return out.get("psnr", []), out.get("loss", [])


class StageTimer:
    """Wall-clock stage timing, printed like the reference codec stages.
    (reference: nnc/compression.py:384-555)"""

    def __init__(self, verbose=True):
        self.verbose = verbose
        self.times = {}

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        if self.verbose:
            print(f"\t{name}...", end="", flush=True)
        yield
        dt = time.perf_counter() - t0
        self.times[name] = dt
        if self.verbose:
            print(f"DONE in {dt:.4f} s")
