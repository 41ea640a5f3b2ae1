"""Run one cell of the benchmark of ``nnc_tpu_torch`` once, on the CUDA card
this process sees:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell is ``benchmark/workloads/<cell>.json``; it names its configuration
(``benchmark/configs/<config>.json``) and its driver
(``benchmark/drivers/<driver>.py``). With ``--trace 0`` the line's metrics
are the cell's end-to-end metrics in ``BENCHMARK.json``; with ``--trace 1``
the window runs under ``torch.profiler`` and they are its per-layer metrics,
each read by ``benchmark/metrics/<metric>.py``. The last line of standard
output is the result, one JSON object; the last lines of standard error
give each compared number beside its limit. Without a card, or with fewer
cards than the cell asks for, the run prints no result and exits with 2.

``--control tf32`` puts the reference, computed in TF32, in the program's
place, and ``--control bfloat16`` runs the program's bf16 route: the
comparison must find both not correct. The benchmark's runs use neither.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from benchmark import harness  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "nnc_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def peaks(cfg: dict, kind: str) -> dict:
    """The card's published dense peaks for the configuration's type."""
    table = harness.load_json(harness.HERE, "peaks.json")
    card = next((v for k, v in table["cards"].items() if k in kind), None)
    if card is None:
        return {"flops": float("nan"), "bytes": float("nan")}
    return {"flops": card["flops"][cfg["precision"]],
            "bytes": card["bytes_per_s"]}


def execute(r: harness.Run, bench: dict, t0: float = T0,
            outcome: dict | None = None) -> dict:
    """One run of ``r``: its result line as a dict; ``outcome`` receives
    the driver's :class:`harness.Outcome` under "outcome"."""
    driver = harness.module("drivers", r.wl["driver"])
    out = driver.run(r)
    if outcome is not None:
        outcome["outcome"] = out
    wanted = harness.metrics_of(r.cell, bench, r.trace)
    cuda = r.device.type == "cuda"
    kind = torch.cuda.get_device_name(r.device) if cuda else "cpu"
    metrics = {}
    if not r.trace:
        values = dict(out.metrics, setup_s=out.setup_end - t0)
        for m in wanted:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        ctx = {"trace": out.trace, "counts": out.counts,
               "peak": peaks(r.cfg, kind)}
        for m in wanted:
            value = harness.module("metrics", m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(harness.finite(v) and v <= limit
                  for v, limit in out.checks.values())
    device = {"platform": "gpu" if cuda else "cpu", "kind": kind,
              "count": 1, "memory_peak_bytes": int(out.memory_peak)}
    line = {"correct": correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": metrics, "device": device}
    if r.trace and out.trace is not None:
        device.update(busy_s=out.trace["busy_s"],
                      window_s=out.trace["window_s"])
        from benchmark.trace import breakdown
        line["breakdown"] = breakdown(out.trace)
    line["checks"] = {name: {"value": v, "limit": limit}
                      for name, (v, limit) in out.checks.items()}
    return line


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32", "bfloat16"))
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    bench = harness.benchmark_json()
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < entry["chips"]:
        print(f"{args.workload} needs {entry['chips']} CUDA device(s); "
              f"this process sees {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    r = harness.Run(cell=args.workload, wl=harness.workload(args.workload),
                    seed=args.seed, seconds=args.seconds,
                    trace=bool(args.trace), device=torch.device("cuda", 0),
                    control=args.control)
    line = execute(r, bench)
    found = forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
