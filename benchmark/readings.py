"""The readings that set a cell's limits: the compared numbers of the
program, or of a control, over many seeds in one process (one set-up of
torch and the kernels), one JSON line a seed; ``--fault`` plants one of ``faults.FAULTS`` under the
timed path:

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 3
        [--seconds 1] [--control tf32|bfloat16] [--fault <name>]

Needs a CUDA card, as ``run.py`` does. The benchmark's own runs do not run
it.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

from benchmark import faults, harness, run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control", choices=("tf32", "bfloat16"))
    ap.add_argument("--fault", choices=sorted(faults.FAULTS))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    bench = harness.benchmark_json()
    wl = harness.workload(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = {}
        r = harness.Run(cell=args.workload, wl=wl, seed=seed,
                        seconds=args.seconds, trace=False,
                        device=torch.device("cuda", 0), control=args.control)
        with faults.planted(args.fault) if args.fault else \
                contextlib.nullcontext():
            line = run.execute(r, bench, t0, got)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": args.control, "fault": args.fault,
                          "checks": {k: c["value"] for k, c in
                                     line["checks"].items()},
                          "metrics": {k: m["value"] for k, m in
                                      line["metrics"].items()},
                          "seconds": time.perf_counter() - t0,
                          "detail": got["outcome"].counts.get("detail")}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
