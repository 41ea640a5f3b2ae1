"""The port's bench (nnc_tpu_torch/bench.py) on the CPU, where the kernels'
wrappers run their plain versions, held against the same computation
through nnc_tpu (the root bench.py's stages composed as it composes them),
in float32 at small sizes (crop 8x16, frame 16x16, grids at res 16):
  * render: the fast crop's max |rgb deviation| from the exact crop within
    1e-5 of the reference's, the active-ray fractions equal;
  * quality sweep: devPSNR on the solid, the reference's PRNGKey(7 / 8) fog
    (carried by ``from_jax_params``) and the turbo teacher within 0.05 dB,
    the open boundaries equal;
  * train: one step's loss and updated scales on the reference bench's
    batch, its draws replayed, equal to ``make_train_step``'s (its plain
    route) at rtol 2e-4 / atol 2e-6, on the exact and the occupancy loss;
  * codec: the bitstream of the reference's PRNGKey(0 / 1) state dict as
    long as the reference's;
and ``main()`` in both types at tiny sizes (one JSON line, last, with the
reference's keys), its error line, its refusal to run without a card, the
reference's pause test on the port's copy of ``_pause_contenders``, the
loops' timing (``loop_ms``) and ``tools/bench_loops`` at tiny sizes.
"""
import ast
import functools
import importlib.util
import json
import os
import time
import types

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from nnc_tpu import compression as jcompression
from nnc_tpu.data import synthetic as jsynthetic
from nnc_tpu.models import nerf as jnerf
from nnc_tpu.render import occupancy as jocc
from nnc_tpu.render import renderer as jrenderer
from nnc_tpu.render.rays import get_rays_np as jget_rays_np
from nnc_tpu.train import lsa as jlsa
from nnc_tpu_torch import bench
from nnc_tpu_torch.data import synthetic as tsynthetic
from nnc_tpu_torch.models import nerf as tnerf
from nnc_tpu_torch.render import occupancy as tocc
from nnc_tpu_torch.tools import bench_loops, render_work
from nnc_tpu_torch.train import lsa as tlsa
from nnc_tpu_torch.utils import contenders, platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
NEAR, FAR = 2.0, 6.0
CROP, FRAME, RES = (8, 16), (16, 16), 16
DROPPED = {"timing_note_r2_numbers_pessimistic_pct"}
K8 = {"lsa_train_step_ms_nrand1024_k8", "lsa_occ_train_step_ms_nrand1024_k8"}


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny sizes: one intra-op thread keeps the bench fast beside other
    test workers; later tests in this worker get the count back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def solid():
    """The reference's solid teacher and its render config (bench.py:
    58-62, one chunk of the crop)."""
    cfg = jnerf.NeRFConfig()
    rc = jrenderer.RenderConfig(
        mlp=cfg, n_samples=64, n_importance=128, white_bkgd=True,
        chunk=CROP[0] * CROP[1], use_fused_mlp=True,
        use_fused_compositing=True, early_term_eps=1e-4, empty_ray_eps=1e-3)
    return cfg, rc, jsynthetic.make_solid_mlp(cfg)


def _jrays(H, W):
    ro, rd = render_work.frame_rays(H, W, "cpu")
    jro, jrd = jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy())
    return jro, jrd, jrd / jnp.linalg.norm(jrd, axis=-1, keepdims=True)


def _jgrid(params, cfg, **kw):
    return jocc.build_occupancy_grid(params, None, cfg, res=RES,
                                     use_fused=False, chunk=32768, **kw)


def _jfast(params, grid, rc, layout, subsample=4):
    """The reference's jitted fast render of a frame's rays (bench.py:
    103-107)."""
    return jax.jit(lambda ro, rd, vd: jocc.render_rays_fast(
        params, None, ro, rd, vd, NEAR, FAR, grid, rc, n_candidates=48,
        budget=16, layout=layout, subsample=subsample))


def test_solid_teacher_is_the_references():
    """The bench's teacher, ``make_solid_mlp`` of both packages, holds the
    same numbers (torch's (out, in) against the reference's (in, out))."""
    want = jsynthetic.make_solid_mlp(jnerf.NeRFConfig())
    got = tsynthetic.make_solid_mlp(tnerf.NeRFConfig()).layers()
    assert set(got) == set(want)
    for name, layer in got.items():
        np.testing.assert_array_equal(layer.weight.detach().numpy().T,
                                      np.asarray(want[name]["w"]))
        np.testing.assert_array_equal(layer.bias.detach().numpy(),
                                      np.asarray(want[name]["b"]))


def test_render_matches_jax(solid):
    """Stage 1 on the 8x16 crop and the 16x16 frame: the fast crop's max
    deviation from the exact crop and both active fractions, against the
    reference's render_chunk / render_rays_fast on the same grid."""
    cfg, rc, params = solid
    got = bench.bench_render(tnerf.NeRFConfig(), CPU, crop_hw=CROP,
                             frame_hw=FRAME, iters=1, res=RES)
    jgrid = _jgrid(params, cfg)
    tgrid = tocc.build_occupancy_grid(
        tsynthetic.make_solid_mlp(tnerf.NeRFConfig()), res=RES)
    np.testing.assert_array_equal(tgrid.occ.numpy(), np.asarray(jgrid.occ))
    crop = _jrays(*CROP)
    exact = jrenderer.render_chunk(params, params, None, None, *crop[:2],
                                   NEAR, FAR, jax.random.PRNGKey(0), rc, True)
    fast = _jfast(params, jgrid, rc, CROP)(*crop)
    dev = float(np.abs(np.asarray(fast["rgb_map"])
                       - np.asarray(exact["rgb_map"])).max())
    assert abs(got["max_rgb_dev"] - dev) <= 1e-5
    assert dev > 0
    assert got["active_fraction_crop"] == float(
        (np.asarray(exact["acc_map"]) > 1e-3).mean())
    frame = _jfast(params, jgrid, rc, FRAME)(*_jrays(*FRAME))
    assert got["frame_active_fraction"] == float(
        (np.asarray(frame["acc_map"]) > 1e-3).mean())
    assert 0 < got["frame_active_fraction"] < 1
    assert all(np.isfinite(got[k]) and got[k] > 0 for k in (
        "exact_rays_per_s", "fast_crop_rays_per_s", "frame_rays_per_s"))


def test_quality_sweep_matches_jax(solid):
    """Stage 2 on the crop's size: devPSNR of the solid, the reference's
    fog (PRNGKey(7 / 8), carried) and the turbo teacher within 0.05 dB of
    the reference's sweep (bench.py:169-190), the open boundaries equal."""
    cfg, rc, params = solid
    fog_j = [jsynthetic._activate(jnerf.init_params(
        jax.random.PRNGKey(s), cfg), s) for s in (7, 8)]
    fog_t = [tnerf.from_jax_params(jax.tree.map(np.asarray, p),
                                   tnerf.NeRFConfig()) for p in fog_j]
    got = bench.bench_quality(tnerf.NeRFConfig(), CPU, hw=CROP, res=RES,
                              fog=fog_t)
    H, W = CROP
    K = np.array([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]],
                 np.float32)
    views = []
    for pose in jsynthetic.look_at_poses(4, seed=1):
        ro, rd = jget_rays_np(H, W, K, pose[:3, :4])
        ro, rd = jnp.asarray(ro.reshape(-1, 3)), jnp.asarray(rd.reshape(-1, 3))
        views.append((ro, rd, rd / jnp.linalg.norm(rd, axis=-1,
                                                   keepdims=True)))

    def sweep(p_c, p_f, dilate=3, subsample=4):
        grid = _jgrid(p_c, cfg, dilate=dilate)
        run_fast = _jfast(p_f, grid, rc, CROP, subsample)
        worst = np.inf
        for ro, rd, vd in views:
            exact = jrenderer.render_chunk(p_c, p_f, None, None, ro, rd, NEAR,
                                           FAR, jax.random.PRNGKey(0), rc,
                                           True)
            fast = run_fast(ro, rd, vd)
            mse = float(np.mean((np.asarray(fast["rgb_map"], np.float64)
                                 - np.asarray(exact["rgb_map"])) ** 2))
            worst = min(worst, -10.0 * np.log10(max(mse, 1e-12)))
        return worst, bool(grid.open_boundary)

    want = {"solid": sweep(params, params), "fog": sweep(*fog_j),
            "turbo": sweep(params, params, dilate=5, subsample=8)}
    for name, (psnr, is_open) in want.items():
        assert abs(got[f"{name}_devpsnr"] - psnr) <= 0.05, name
    assert (got["solid_open"], got["fog_open"]) == \
        (want["solid"][1], want["fog"][1]) == (False, True)
    assert np.isfinite([got[f"{n}_devpsnr"] for n in want]).all()


def _reference_batch(n, shift):
    """bench.py:229-234 at ``n`` rays, the origins moved by ``shift``."""
    key = jax.random.PRNGKey(0)
    ro = jax.random.normal(key, (n, 3)) * 0.1 + jnp.asarray(shift)
    rd = jax.random.normal(jax.random.fold_in(key, 1), (n, 3)) * 0.2 + \
        jnp.array([0, 0, -1.0])
    vd = rd / jnp.linalg.norm(rd, axis=-1, keepdims=True)
    tgt = jax.random.uniform(jax.random.fold_in(key, 2), (n, 3))
    return key, (ro, rd, vd, tgt)


# the reference bench's batch, of whose first 16 rays (from about the
# origin towards -z, near 2, far 6) none meets the solid, so that its step
# moves no scale; and the same batch moved to start at z = 4, whose rays
# cross it
BATCHES = {"bench": (0.0, 0.0, 0.0), "crossing": (0.0, 0.0, 4.0)}


@pytest.mark.parametrize("batch_name", sorted(BATCHES))
@pytest.mark.parametrize("loss", ["exact", "occupancy"])
def test_train_step_matches_jax(loss, batch_name):
    """Stage 3's step (train_setup) on 16 rays of the reference bench's
    batch, one step from scales of one: the loss and the scales against
    ``make_train_step``'s plain route (the key's draws replayed: t_rand and
    u of render_rays, renderer.py:119), and the scales' movement at the
    same bars."""
    n = 16
    key, batch = _reference_batch(n, BATCHES[batch_name])
    cfg = jnerf.NeRFConfig()
    rc = jrenderer.RenderConfig(mlp=cfg, n_samples=64, n_importance=128,
                                use_fused_train=False)
    params = (jsynthetic.make_solid_mlp(cfg), jsynthetic.make_solid_mlp(cfg))
    scales = (jnerf.init_lsa_scales(cfg), jnerf.init_lsa_scales(cfg))
    optimizer = optax.adam(1e-4)
    jgrid = tgrid = None
    if loss == "occupancy":
        jgrid = _jgrid(params[1], cfg, dilate=1)
        tgrid = tocc.build_occupancy_grid(
            tsynthetic.make_solid_mlp(tnerf.NeRFConfig()), res=RES,
            dilate=1)
        np.testing.assert_array_equal(tgrid.occ.numpy(),
                                      np.asarray(jgrid.occ))
    step = jlsa.make_train_step(rc, optimizer, grid=jgrid, occ_budget=32)
    want_sc, _st, want_loss, _img = step(scales, optimizer.init(scales),
                                         params, *batch, NEAR, FAR, key)
    models, _adam, tstep, trc = bench.train_setup(tnerf.NeRFConfig(), CPU,
                                                  tgrid)
    draws = {}
    if loss == "exact":
        k_strat, k_pdf, _k0, _k1 = jax.random.split(key, 4)
        t = lambda a: torch.from_numpy(np.array(a))
        draws = {"t_rand": t(jax.random.uniform(k_strat, (n, 64))),
                 "u": t(jax.random.uniform(k_pdf, (n, 128)))}
    assert set(draws) == set(bench.train_draws(n, trc, CPU, tgrid))
    packed = torch.cat([torch.from_numpy(np.array(a)) for a in batch], 1)
    out = tstep(packed, draws, torch.as_tensor(tlsa.Adam.hyper(bench.LR, 0)))
    np.testing.assert_allclose(float(out[0]), float(want_loss), rtol=2e-4)
    moved = 0.0
    for model, w_sc in zip(models, want_sc):
        for name, layer in model.layers().items():
            got = layer.weight_scaling.detach().numpy().reshape(-1)
            w = np.asarray(w_sc[name])
            np.testing.assert_allclose(got, w, rtol=2e-4, atol=2e-6,
                                       err_msg=name)
            np.testing.assert_allclose(got - 1, w - 1, rtol=2e-4, atol=2e-6,
                                       err_msg=name)
            moved = max(moved, float(np.abs(w - 1).max()))
    assert (moved > 5e-5) == (batch_name == "crossing"), moved


def test_codec_bitstream_is_the_references():
    """Stage 4 on the reference's PRNGKey(0 / 1) float32 state dict: the
    bitstream as long as the reference's (bench.py:260-301), so the same
    ratio."""
    cfg = jnerf.NeRFConfig()
    sd = {}
    for prefix, seed in (("model.", 0), ("model_fine.", 1)):
        sd.update(jnerf.params_to_state_dict(
            jnerf.init_params(jax.random.PRNGKey(seed), cfg), prefix))
    sd = {k: np.asarray(v) for k, v in sd.items()}
    want = jcompression.compress(sd, bitstream_path=None, qp=-20,
                                 return_bitstream=True, verbose=False)
    got = bench.bench_codec(sd, device=CPU)
    raw = sum(v.nbytes for v in sd.values())
    assert got["raw_bytes"] == raw
    assert got["bytes"] == len(want)
    assert got["ratio"] == len(want) / raw
    assert got["encode_MBps"] > 0 and got["decode_MBps"] > 0


def _reference_keys():
    """The extra_metrics keys of the root bench.py's line, read from its
    source."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "extra_metrics"
                for k in node.keys):
            extra = node.values[[k.value for k in node.keys].index(
                "extra_metrics")]
            if len(extra.keys) > 3:
                return {k.value for k in extra.keys}
    raise AssertionError("no extra_metrics in bench.py's line")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_main_prints_one_line_last(monkeypatch, capsys, dtype):
    """main() at tiny sizes, its LSA steps on 8 rays in calls of 2."""
    monkeypatch.setenv(platform.DEVICE_ENV, "cpu")
    monkeypatch.setattr(bench, "bench_train", functools.partial(
        bench.bench_train, n=8, steps_per_call=2))
    line = bench.main(["--dtype", dtype, "--hw", "4", "8", "--frame", "8",
                       "8", "--res", "8", "--iters", "1", "--train-iters",
                       "1"])
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == "device: cpu"
    assert [ln for ln in out if ln.startswith("{")] == [out[-1]]
    assert json.loads(out[-1]) == line
    assert line["metric"] == "render_rays_per_sec_per_chip"
    assert line["unit"] == "rays/s" and line["dtype"] == dtype
    assert "vs_baseline" not in line and "error" not in line
    assert set(line["extra_metrics"]) == _reference_keys() - DROPPED | K8
    values = [line["value"], *line["extra_metrics"].values()]
    assert np.isfinite(values).all() and line["value"] > 0
    assert line["sizes"] == {"crop": [4, 8], "frame": [8, 8], "res": 8,
                             "iters": 1, "train_iters": 1}
    assert line["extra_metrics"]["lsa_train_rays_per_sec"] == round(
        8 / (line["extra_metrics"]["lsa_train_step_ms_nrand1024"] / 1e3), 1)


def test_a_failing_stage_prints_one_error_line(monkeypatch, capsys):
    monkeypatch.setenv(platform.DEVICE_ENV, "cpu")

    def boom(*_a, **_kw):
        raise ValueError("stage failed")
    monkeypatch.setattr(bench, "bench_render", boom)
    with pytest.raises(ValueError, match="stage failed"):
        bench.main([])
    out = capsys.readouterr().out.strip().splitlines()
    assert [ln for ln in out if ln.startswith("{")] == [out[-1]]
    assert json.loads(out[-1]) == {
        "metric": "render_rays_per_sec_per_chip", "value": 0.0,
        "unit": "rays/s", "error": "ValueError: stage failed"}


def test_no_card_raises_and_runs_nothing(monkeypatch, capsys):
    """Without CUDA and without NNC_TPU_TORCH_DEVICE: require_cuda()
    raises through main() after the error line; no stage ran."""
    monkeypatch.delenv(platform.DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ran = []
    for stage in ("bench_render", "bench_quality", "bench_train",
                  "bench_codec"):
        monkeypatch.setattr(bench, stage, lambda *a, _s=stage, **kw:
                            ran.append(_s))
    with pytest.raises(RuntimeError, match="CUDA device"):
        bench.main([])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and ran == []
    rec = json.loads(out[0])
    assert rec["value"] == 0.0 and "CUDA" in rec["error"]


def test_pause_contenders_stops_and_resumes(tmp_path, monkeypatch):
    """tests/test_bench_degraded.py's pause test, run against the port's
    copy of PAUSE_FILE, _pause_contenders and _resume_contenders
    (utils/contenders.py, which the bench's program runs)."""
    spec = importlib.util.spec_from_file_location(
        "bench_degraded", os.path.join(REPO, "tests",
                                       "test_bench_degraded.py"))
    degraded = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(degraded)
    monkeypatch.setattr(degraded, "bench", contenders)
    degraded.test_pause_contenders_stops_and_resumes(tmp_path, monkeypatch)


def test_paused_resumes_on_system_exit(tmp_path, monkeypatch):
    """The bench's program turns SIGTERM into SystemExit(143); leaving
    ``contenders.paused()`` that way resumes what it stopped."""
    import signal
    import subprocess
    import sys
    import time

    sleeper = subprocess.Popen([sys.executable, "-c",
                                "import time; time.sleep(60)"])
    state = lambda: open(f"/proc/{sleeper.pid}/stat").read() \
        .rsplit(")", 1)[1].split()[0]
    try:
        pause_file = tmp_path / "pause.pids"
        pause_file.write_text(f"{sleeper.pid}\n")
        monkeypatch.setattr(contenders, "PAUSE_FILE", str(pause_file))
        with pytest.raises(SystemExit):
            with contenders.paused() as stopped:
                assert stopped == [sleeper.pid]
                for _ in range(50):
                    if state() == "T":
                        break
                    time.sleep(0.02)
                assert state() == "T"
                raise SystemExit(143)
        for _ in range(50):
            if state() != "T":
                break
            time.sleep(0.02)
        assert state() != "T"
    finally:
        sleeper.send_signal(signal.SIGKILL)
        sleeper.wait()


def test_loop_ms_warms_then_times_each_call(monkeypatch):
    """loop_ms: fn(0) for WARMUP_S (at least once), then fn(1) ... fn(n),
    on a host clock that each call moves by 1/64 s (exact in binary)."""
    clock = types.SimpleNamespace(t=0.0)
    clock.perf_counter = lambda: clock.t
    monkeypatch.setattr(bench, "time", clock)
    seen = []

    def fn(i):
        seen.append(i)
        clock.t += 1 / 64
    monkeypatch.setattr(bench, "WARMUP_S", 0.0)
    assert bench.loop_ms(fn, 3, CPU) == 1e3 / 64
    assert seen == [0, 1, 2, 3]
    seen.clear()
    monkeypatch.setattr(bench, "WARMUP_S", 5 / 64)
    assert bench.loop_ms(fn, 2, CPU) == 1e3 / 64
    assert seen == [0, 0, 0, 0, 0, 1, 2]


def test_bench_loops_parts_on_cpu():
    """tools/bench_loops at tiny sizes: each series holds one issue and
    one host time a call (no device span on the CPU), each loop its host
    wall and the bench's time, and the single LSA steps run."""
    cfg = tnerf.NeRFConfig()
    parts = bench_loops.frame_parts(cfg, CPU, frame_hw=(8, 8),
                                    crop_hw=(4, 8), res=8, calls=3,
                                    loops=(1, 2), idle_s=0.0)
    for name, calls in (("cold", 3), ("after_load", 3),
                        ("after_idle", bench_loops.IDLE_CALLS)):
        s = parts[name]
        assert len(s["issue_ms"]) == len(s["host_ms"]) == calls, name
        assert s["device_ms"] is None
        assert all(0 < a <= b for a, b in zip(s["issue_ms"], s["host_ms"]))
    assert [lp["n"] for lp in parts["loops"]] == [1, 2]
    assert all(lp["wall_ms"] > 0 and lp["bench_ms"] > 0
               and lp["busy_ms"] is None for lp in parts["loops"])
    steps = bench_loops.occ_step_series(cfg, CPU, n=8, res=8, calls=2)
    assert len(steps["host_ms"]) == 2
    json.dumps(parts)


def test_bench_loops_sampler_reads_nvidia_smi_lines():
    """The sampler starts nothing on the CPU; on the card it keeps the
    samples inside a part's span (local time to the ms)."""
    with bench_loops.Sampler(CPU) as smi:
        pass
    assert smi.lines == [] and smi.within((0, 2e9)) == []
    stamp = time.mktime((2026, 10, 18, 4, 0, 0, 0, 0, -1))
    lines = ["2026/10/18 04:00:00.250, 1980, 312.45",
             "2026/10/18 04:00:01.500, 1755, 140.10", "[N/A], 1, 2"]
    smi.lines = [m.groups() for m in map(bench_loops.SAMPLE.match, lines)
                 if m]
    assert smi.within((stamp, stamp + 1)) == [(1980.0, 312.45)]
    assert smi.within((stamp, stamp + 2)) == [(1980.0, 312.45),
                                              (1755.0, 140.1)]
    assert bench_loops.clocks(smi.within((stamp, stamp + 2))).startswith(
        "SM 1755-1980 MHz")
