"""The comparison that decides ``correct``: sound runs pass, the control
(the reference in TF32 in the program's place) fails, and so does a run
whose timed path is broken underneath, for each fault a cell can have."""
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import faults, harness
import _tiny

CELLS = sorted(_tiny.SIZES)
SEPARATE = {"lsa": ("loss_gap_median", "grad_gap_median"),
            "render": ("rgb_rms",), "frame": ("rgb_rms",)}


@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_runs_are_correct(cell, seed):
    """A sound tiny run reads under every limit set on the card."""
    line = _tiny.line(cell, seed=seed)
    assert line["correct"], line["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_tf32_control_reads_further_off(cell):
    """The control, the reference in TF32 in the program's place, reads
    further from the float32 reference than the program does on the
    numbers that separate them on the card (an LSA cell's median step and
    median leaf; a view's or a frame's rms)."""
    sound = _tiny.line(cell)["checks"]
    control = _tiny.line(cell, control="tf32")["checks"]
    for name in SEPARATE[harness.workload(cell)["driver"]]:
        assert control[name]["value"] > sound[name]["value"], name


FAULTS = [(cell, name) for cell in CELLS for name in faults.OF_DRIVER[
    harness.workload(cell)["driver"]]]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    with faults.planted(fault):
        line = _tiny.line(cell)
    assert not line["correct"], line["checks"]


def _readings(cell, *args):
    proc = subprocess.run(
        [sys.executable, "benchmark/readings.py", "--workload", cell,
         "--seeds", "901", "902", "903", "--seconds", "1", *args],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=1500,
        env=dict(os.environ))
    assert proc.returncode == 0, proc.stderr[-3000:]
    limits = harness.workload(cell)["limits"]
    return [{k: v <= limits[k] for k, v in json.loads(l)["checks"].items()}
            for l in proc.stdout.splitlines() if l.startswith("{")]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_on_the_card_sound_runs_pass_and_the_control_fails(cell):
    """At the cell's own size, on three seeds: the program passes every
    compared number, and the TF32 control fails one (run the benchmark's
    tests on a machine with a card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    assert all(all(r.values()) for r in _readings(cell))
    assert all(not all(r.values()) for r in _readings(cell, "--control",
                                                       "tf32"))
