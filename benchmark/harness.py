"""What every cell's run shares: the files found by name, the program's
models built from the benchmark's weights, the comparison of a number with
its limit, and the run's context handed to the drivers and the metric
readers."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def benchmark_json() -> dict:
    return load_json(ROOT, "BENCHMARK.json")


def workload(name: str) -> dict:
    """``workloads/<name>.json``, with its configuration
    (``configs/<config>.json``) under ``cfg``."""
    wl = load_json(HERE, "workloads", name + ".json")
    wl["cfg"] = load_json(HERE, "configs", wl["config"] + ".json")
    return wl


def module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark, loaded from its file (a
    metric's name may hold dots)."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_of(cell: str, bench: dict, traced: bool) -> list:
    """The metric entries a run of ``cell`` reports: the end-to-end ones
    that name the cell (or name none), or with ``traced`` the per-layer
    ones that name it (or, naming none, move a metric the cell reports)."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [])
            or ("workloads" not in m and m["moves"] in moved)]


def port_model(weights: dict, cfg: dict, device, compute_dtype=None):
    """The program's NeRF module holding ``weights`` ({layer: (w, b)})."""
    from nnc_tpu_torch.models import nerf
    net = cfg["net"]
    config = nerf.NeRFConfig(
        D=net["netdepth"], W=net["netwidth"],
        input_ch=3 + 6 * net["multires"],
        input_ch_views=3 + 6 * net["multires_views"],
        skips=tuple(net["skips"]),
        compute_dtype=compute_dtype or getattr(torch, cfg["precision"]))
    model = nerf.NeRF(config, device=device)
    with torch.no_grad():
        for name, layer in model.layers().items():
            layer.weight.copy_(weights[name][0])
            layer.bias.copy_(weights[name][1])
    return model


def render_config(cfg: dict, compute_dtype=None, chunk=None):
    """The program's render configuration as its CLI makes it for this
    configuration (``presets.make_render_config`` with the kernels on)."""
    from nnc_tpu_torch.models import nerf
    from nnc_tpu_torch.train import presets
    s, net = cfg["sampling"], cfg["net"]
    mlp = nerf.NeRFConfig(
        D=net["netdepth"], W=net["netwidth"],
        input_ch=3 + 6 * net["multires"],
        input_ch_views=3 + 6 * net["multires_views"],
        skips=tuple(net["skips"]),
        compute_dtype=compute_dtype or getattr(torch, cfg["precision"]))
    scene = {"white_bkgd": cfg["render"]["white_bkgd"],
             "raw_noise_std": s["raw_noise_std"],
             "n_importance": s["N_importance"]}
    return presets.make_render_config(
        scene, mlp, chunk=chunk or cfg["render"]["chunk"],
        use_fused_mlp=True, n_samples=s["N_samples"],
        n_importance=s["N_importance"])


@dataclasses.dataclass
class Run:
    """One run of a cell. ``control``: None (the program), "tf32" (the
    reference in TF32 in the program's place) or "bfloat16" (the program's
    bf16 route); ``sizes``: overrides of the cell's sizes (CPU tests)."""
    cell: str
    wl: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    control: str | None = None
    sizes: dict | None = None

    @property
    def cfg(self) -> dict:
        return self.wl["cfg"]

    def size(self, key, default):
        return (self.sizes or {}).get(key, default)

    @property
    def compute_dtype(self):
        return torch.bfloat16 if self.control == "bfloat16" else None


@dataclasses.dataclass
class Outcome:
    """What a driver hands back: the end-to-end metrics it measured, the
    requests attempted and failed, the compared numbers as {name: (value,
    limit)}, the device's peak memory, the traced window's summary and the
    counts the per-layer readers take."""
    metrics: dict
    attempted: int
    failed: int
    checks: dict
    memory_peak: int
    trace: dict | None
    counts: dict
    setup_end: float


def gap(a: float, b: float) -> float:
    return abs(a - b) / abs(b) if b else abs(a - b)


def norm_gaps(program: dict, reference: dict) -> list:
    """Each leaf's gap of norms: |program - reference| over the larger of
    the reference's norm of the leaf and of the median leaf; leaves whose
    reference norm is under a thousandth of the median leaf's move by
    rounding alone and are left out."""
    med = float(np.median(list(reference.values()))) or 1e-30
    return [abs(program[k] - reference[k]) / max(reference[k], med)
            for k, r in reference.items() if r >= 1e-3 * med]


def rms(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.sqrt(torch.mean((a.double() - b.double()) ** 2)))


def quantile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values), 100 * q))


def free_device(device) -> None:
    import gc
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)
