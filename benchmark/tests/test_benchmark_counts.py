"""The operation counts give PERF.md's per-point figures at both
configurations' shapes."""
import pytest

from benchmark import harness
from benchmark.counts import kb1, kb2, model


@pytest.mark.parametrize("config", ["lego", "fern"])
def test_per_point_figures(config):
    net = harness.load_json(harness.HERE, "configs", config + ".json")["net"]
    assert model.forward_macs(net) == 593_408
    assert model.forward_flops(net) == 1_186_816          # 1.19 MFLOP
    assert model.backward_macs(net) == 557_696
    assert model.train_flops(net) == 2 * (593_408 + 557_696)


def test_an_lsa_step_of_lego():
    net = harness.load_json(harness.HERE, "configs", "lego.json")["net"]
    points = 1024 * (64 + 64 + 128)
    assert points == 262_144
    assert abs(kb1.operations(net, points) / 1e9 - 603.5) < 0.1
    assert kb2.operations(net, 1) == 1_186_816
