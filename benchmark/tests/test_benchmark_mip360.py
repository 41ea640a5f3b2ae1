"""The driver ``lsa_mip360`` (the cell ``mip360-garden.lsa``) through a
whole run at tiny sizes on the CPU (the program's plain versions), the TF32
control reading further off, the MLPs' counts, and the three metric readers
of mip-NeRF 360 on a synthetic trace."""
import json
import math

import pytest
import torch

from benchmark import harness, run
from benchmark.counts import mlp360

SIZES = {"mip360-garden.lsa": dict(N_rand=16, H=8, W=12, nerf_width=32,
                                   prop_width=16, bottleneck_width=16,
                                   net_width_viewdirs=8, max_deg_point=3,
                                   num_prop_samples=8, num_nerf_samples=4)}


def line(cell, seed=7, trace=False, control=None):
    r = harness.Run(cell=cell, wl=harness.workload(cell), seed=seed,
                    seconds=0.2, trace=trace, device=torch.device("cpu"),
                    control=control, sizes=SIZES[cell])
    got = {}
    out = run.execute(r, harness.benchmark_json(), outcome=got)
    return out, got["outcome"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(SIZES))
def test_tiny_runs_are_correct_and_report_their_metrics(cell, trace):
    out, outcome = line(cell, seed=2 ** 33 + 5, trace=trace)
    assert out["correct"], out["checks"]
    wanted = harness.metrics_of(cell, harness.benchmark_json(), trace)
    got = set(out["metrics"])
    if trace:
        # the CPU has no device trace: only the spans' metrics are read
        spans = {m["name"] for m in wanted if m["source"] == "program_span"}
        assert spans <= got <= {m["name"] for m in wanted}
    else:
        assert got == {m["name"] for m in wanted}
        assert set(outcome.metrics) == {"lsa_rays_per_s"}
    assert outcome.attempted > 0 and outcome.counts["requests"] > 0
    json.dumps(out)


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_the_tf32_control_reads_further_off(cell):
    sound = line(cell)[0]["checks"]
    control = line(cell, control="tf32")[0]["checks"]
    assert control["grad_gap_median"]["value"] > \
        sound["grad_gap_median"]["value"]


def test_mlp360_counts():
    net = harness.workload("mip360-garden.lsa")["cfg"]["net"]
    samp = harness.workload("mip360-garden.lsa")["cfg"]["sampling"]
    assert mlp360.forward_macs(net, "prop") == 325_888
    assert mlp360.forward_macs(net, "nerf") == 8_672_000
    # the backward skips each MLP's first layer and the encodings' rows
    assert mlp360.backward_macs(net, "prop") == 325_888 - 504 * 256
    assert mlp360.backward_macs(net, "nerf") == \
        8_672_000 - 504 * 1024 - 504 * 1024 - 27 * 128
    flops = mlp360.step_flops(net, samp, 16_384)
    assert math.isclose(flops / 1e12, 19.293, rel_tol=1e-4)
    # K-B7: 20 bytes an output element, 16 in each first layer
    outs = {m: sum(o for _i, o in mlp360.dims(net, m).values())
            for m in ("prop", "nerf")}
    want = 16_384 * (128 * (20 * outs["prop"] - 4 * 256)
                     + 32 * (20 * outs["nerf"] - 4 * 1024))
    assert mlp360.kb7_bytes(net, samp, 16_384) == want


def _ctx(ops):
    """A synthetic traced window: 1.0 s busy of a 1.25 s window, the GEMMs
    0.6 s, K-B7 0.1 s, the rest 0.3 s, over 4 steps."""
    return {"trace": {"window_s": 1.25, "busy_s": 1.0, "gaps": [],
                      "ops": {"sm80_xmma_gemm_f32f32_tn": 0.4,
                              "cutlass_80_simt_sgemm_256x128": 0.15,
                              "gemv2T_kernel_val": 0.05,
                              "void lsa_epilogue_bwd_kernel<true, 4>": 0.06,
                              "lsa_epilogue_fwd_kernel_v4<true>": 0.04,
                              "radixSortKVInPlace": 0.1,
                              "vectorized_elementwise_kernel": 0.2}},
            "counts": {"requests": 4, "mlp360_ops": ops,
                       "kb7_bytes": 0.1675e12},
            "peak": {"flops": 495e12, "bytes": 3.35e12}}


def test_new_metric_readers_on_a_synthetic_trace():
    ctx = _ctx(ops=0.7 * 165e12 * 0.5)
    read = lambda name, c=ctx: harness.module("metrics", name).read(c)
    # 0.7 s of GEMMs and K-B7 against 0.35 s at 165 TFLOP/s
    assert read("mlp360_roofline") == pytest.approx(50.0, rel=1e-9)
    # 0.1675 TB in 0.1 s of K-B7 at 3.35 TB/s
    assert read("kb7_roofline") == pytest.approx(50.0, rel=1e-9)
    assert read("mip360_nonmlp_ms") == pytest.approx(1e3 * 0.3 / 4,
                                                     rel=1e-9)
    empty = {"trace": None, "counts": {}, "peak": {}}
    for name in ("mlp360_roofline", "kb7_roofline", "mip360_nonmlp_ms"):
        assert read(name, empty) is None, name
    # a window without the MLPs' kernels reads nothing
    bare = _ctx(ops=1.0)
    bare["trace"]["ops"] = {"mlp_train_fwd": 0.5}
    assert read("mlp360_roofline", bare) is None
    assert read("kb7_roofline", bare) is None

