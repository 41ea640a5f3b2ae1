"""The cells this benchmark took on with mip-NeRF and fern's test views:
their drivers (``lsa_mip``, ``render_ndc``) through a whole run at tiny
sizes on the CPU (the program's plain kernel versions), the TF32 control
reading further off, a planted fault caught, the reference copy equal to
``tests/mipnerf_reference.py`` byte for byte, and K-B1's IPE counts."""
import json
import math
import os

import pytest
import torch

from benchmark import faults, harness, run
from benchmark.counts import kb1_ipe

SIZES = {"mip-lego.lsa": dict(N_rand=16, H=12, W=12, num_samples=8),
         "fern.render": dict(H=12, W=16, N_samples=16, N_importance=16,
                             chunk=64)}


def line(cell, seed=7, trace=False, control=None):
    r = harness.Run(cell=cell, wl=harness.workload(cell), seed=seed,
                    seconds=0.2, trace=trace, device=torch.device("cpu"),
                    control=control, sizes=SIZES[cell])
    return run.execute(r, harness.benchmark_json())


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(SIZES))
def test_tiny_runs_are_correct_and_report_their_metrics(cell, trace):
    out = line(cell, seed=2 ** 33 + 5, trace=trace)
    assert out["correct"], out["checks"]
    bench = harness.benchmark_json()
    wanted = harness.metrics_of(cell, bench, trace)
    got = set(out["metrics"])
    if trace:
        # the CPU has no device trace: the spans' metrics are read
        spans = {m["name"] for m in wanted if m["source"] == "program_span"}
        assert spans and spans <= got <= {m["name"] for m in wanted}
        assert all(math.isfinite(m["value"]) for m in out["metrics"].values())
    else:
        assert got == {m["name"] for m in wanted}
    json.dumps(out)


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_the_tf32_control_reads_further_off(cell):
    sound = line(cell)["checks"]
    control = line(cell, control="tf32")["checks"]
    name = "grad_gap_median" if cell.endswith(".lsa") else "rgb_rms"
    assert control[name]["value"] > sound[name]["value"], name


@pytest.mark.parametrize("cell,fault", [("mip-lego.lsa", "unchanged_state"),
                                        ("mip-lego.lsa", "altered_loss"),
                                        ("fern.render", "altered_view")])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    with faults.planted(fault):
        out = line(cell)
    assert not out["correct"], out["checks"]


def test_reference_copy_is_the_tests_reference():
    here = os.path.join(harness.HERE, "reference", "mipnerf.py")
    tests = os.path.join(harness.ROOT, "tests", "mipnerf_reference.py")
    with open(here, "rb") as a, open(tests, "rb") as b:
        assert a.read() == b.read()


def test_kb1_ipe_counts():
    net = harness.workload("mip-lego.lsa")["cfg"]["net"]
    assert kb1_ipe.forward_macs(net) == 610_304
    assert kb1_ipe.backward_macs(net) == 557_696
    assert kb1_ipe.train_flops(net) == 2 * (610_304 + 557_696)
    # a step: 4,096 rays x 2 levels x 128 samples
    assert kb1_ipe.operations(net, 1_048_576) == 1_048_576 * 2_336_000
    assert math.isclose(kb1_ipe.operations(net, 1_048_576) / 1e12, 2.449,
                        rel_tol=1e-3)
