"""Tiny sizes at which a CPU test drives a whole run of each cell, through
the program's plain kernel versions."""
import torch

from benchmark import harness, run

SIZES = {
    "lego.lsa": dict(N_rand=32, H=16, W=16, N_samples=16, N_importance=16),
    "fern.lsa": dict(N_rand=32, H=16, W=16, N_samples=16, N_importance=16),
    "lego.render": dict(H=16, W=16, N_samples=16, N_importance=16,
                        chunk=128),
    "lego.frame": dict(H=16, W=16, res=16),
}


def line(cell, seed=7, trace=False, control=None, seconds=0.2):
    """The result line of one run of ``cell`` at its tiny size on the
    CPU (the harness's look for a card skipped)."""
    r = harness.Run(cell=cell, wl=harness.workload(cell), seed=seed,
                    seconds=seconds, trace=trace,
                    device=torch.device("cpu"), control=control,
                    sizes=SIZES[cell])
    return run.execute(r, harness.benchmark_json())
