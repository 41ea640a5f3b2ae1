"""The JAX-free tools of nnc_tpu_torch on the CPU: utils/platform,
utils/profiling, the mock evaluator and the port's copies of the root tools
(merge_rd, demo_synthetic, rd_sweep, profile_codec, render_video,
multi_scene) and the synthetic scenes they draw, at tiny sizes with
``NNC_TPU_TORCH_DEVICE=cpu``.

Held against the JAX package or the root tool where one exists: the mock
evaluator's values equal, merge_rd's output equal byte for byte, the
printed JSON keys and the RD record fields the reference's; profile_codec's
dequantized values equal the codec's own reconstruction of its bitstream,
bit for bit.
"""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from nnc_tpu.train import evaluation_nerf_mock as jmock
from nnc_tpu_torch.coder import cabac
from nnc_tpu_torch.core import approximator
from nnc_tpu_torch.data import synthetic as tsynthetic
from nnc_tpu_torch.models import nerf as tnerf
from nnc_tpu_torch.render import occupancy
from nnc_tpu_torch.render import renderer as trenderer
from nnc_tpu_torch.render.rays import get_rays_np
from nnc_tpu_torch.tools import (demo_synthetic, merge_rd, multi_scene,
                                 profile_codec, rd_sweep, render_video)
from nnc_tpu_torch.train import evaluation_nerf_mock as tmock
from nnc_tpu_torch.train import lsa
from nnc_tpu_torch.utils import platform, profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny sizes: one intra-op thread keeps the tools fast beside other
    test workers (as tests/test_torch_port_scan.py does); later tests in
    this worker get the count back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv(platform.DEVICE_ENV, "cpu")


# -- utils/platform, utils/profiling, the mock evaluator --------------------
def test_device_from_env(monkeypatch):
    monkeypatch.setenv(platform.DEVICE_ENV, "cpu")
    assert platform.device_from_env() == torch.device("cpu")
    monkeypatch.delenv(platform.DEVICE_ENV)
    if torch.cuda.is_available():
        assert platform.device_from_env() == torch.device("cuda", 0)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            platform.device_from_env()


def test_trace_if_writes_a_trace_with_the_annotation(tmp_path):
    with profiling.trace_if(str(tmp_path / "on")):
        with profiling.span("nnc_region_marker"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    text = (tmp_path / "on" / profiling.TRACE_FILE).read_text()
    assert "nnc_region_marker" in json.dumps(json.loads(text))
    with profiling.trace_if(str(tmp_path / "off"), enabled=False):
        with profiling.span("nnc_region_marker"):
            torch.ones(4)
    assert not (tmp_path / "off").exists()


def test_trace_if_without_a_log_dir_yields_the_profile(tmp_path,
                                                       monkeypatch):
    """log_dir None: the profile's key_averages hold the region, and no
    file is written; not enabled: None."""
    monkeypatch.chdir(tmp_path)
    with profiling.trace_if(None) as prof:
        with profiling.span("nnc_region_marker"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert "nnc_region_marker" in {e.key for e in prof.key_averages()}
    assert not list(tmp_path.iterdir())
    with profiling.trace_if(None, enabled=False) as prof:
        pass
    assert prof is None


@pytest.mark.parametrize("mode", ["finite", "infinite"])
def test_mock_evaluator_matches_jax(mode):
    values = []
    for mod in (jmock, tmock):
        mod.reset()
        values.append([mod.evaluate_nerf_model(mode=mode)
                       for _ in range(10)])
        mod.reset()
        assert mod.evaluate_nerf_model(mode=mode) == values[-1][0]
    assert values[0] == values[1]
    assert len(set(values[1])) == (6 if mode == "finite" else 10)


# -- merge_rd ----------------------------------------------------------------
def _root_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_merge_rd_matches_root_tool(tmp_path, capsys):
    base = [{"qp": -20, "lsa": False, "bytes": 10, "psnr": 20.0},
            {"qp": -30, "lsa": True, "bytes": 8, "psnr": 19.0,
             "lsa_iters": 100, "epochs": 2, "mode": "ioq",
             "scene": "synthetic_ndc"}]
    new = [{"qp": -20, "lsa": False, "bytes": 11, "psnr": 20.5},
           {"qp": -38, "lsa": True, "bytes": 5, "psnr": 17.0,
            "lsa_iters": 100, "epochs": 2, "mode": "flat",
            "scene": "synthetic"}]
    sweep = tmp_path / "sweep"
    sweep.mkdir()
    (sweep / "rd_results.json").write_text(json.dumps(new))
    outs = []
    for i, mod in enumerate((_root_tool("merge_rd"), merge_rd)):
        into = tmp_path / f"into{i}.json"
        into.write_text(json.dumps(base))
        mod.main([str(sweep), str(sweep / "rd_results.json"),
                  "--into", str(into)])
        outs.append((into.read_text(),
                     capsys.readouterr().out.replace(str(into), "INTO")))
    assert outs[0] == outs[1]
    assert len(json.loads(outs[1][0])) == 3


# -- the tools' synthetic scenes ---------------------------------------------
def _scene_case(maker, width, seed):
    mlp = tnerf.NeRFConfig(W=width)
    rc = trenderer.RenderConfig(mlp=mlp, n_samples=16, n_importance=8,
                                chunk=256)
    return maker(n_images=3, H=8, W=8, mlp=mlp, rc=rc, seed=seed,
                 device="cpu")


def _acc(teachers, scene, i):
    ro, rd = get_rays_np(8, 8, scene["K"], scene["poses"][i, :3, :4])
    rc = trenderer.RenderConfig(mlp=teachers[0].config, n_samples=16,
                                n_importance=8, chunk=256)
    return trenderer.render_image(*teachers, ro, rd, scene["near"],
                                  scene["far"], rc, device="cpu")["acc_map"]


@pytest.mark.parametrize("width, seed, redrawn", [(64, 0, True),
                                                  (16, 0, False)])
def test_random_teacher_is_redrawn_until_its_views_hold_density(
        width, seed, redrawn):
    """W=64 seed 0 (rd_sweep's and multi_scene's scene) draws a teacher
    whose views render black: it is redrawn from the same generator, and
    every view then stops at least MIN_VIEW_OPACITY of the light; a first
    draw that passes is kept."""
    scene, teachers = _scene_case(tsynthetic.make_scene, width, seed)
    first = tsynthetic._random_teachers(tnerf.NeRFConfig(W=width),
                                        torch.Generator().manual_seed(seed))
    kept = all(torch.equal(a, b) for a, b in zip(
        teachers[0].state_dict().values(), first[0].state_dict().values()))
    assert kept is not redrawn
    assert redrawn is (min(float(_acc(first, scene, i).mean())
                           for i in range(3))
                       < tsynthetic.MIN_VIEW_OPACITY)
    for i in range(3):
        assert float(_acc(teachers, scene, i).mean()) >= \
            tsynthetic.MIN_VIEW_OPACITY
        assert scene["images"][i].std() > 0.05


def test_given_teachers_are_not_redrawn_and_no_density_raises(monkeypatch):
    scene, teachers = _scene_case(tsynthetic.make_scene_ndc, 16, 0)
    monkeypatch.setattr(tsynthetic, "MIN_VIEW_OPACITY", 2.0)
    again, same = tsynthetic.make_scene_ndc(
        n_images=3, H=8, W=8, mlp=teachers[0].config, teachers=teachers,
        rc=trenderer.RenderConfig(mlp=teachers[0].config, n_samples=16,
                                  n_importance=8, chunk=256), device="cpu")
    assert same[0] is teachers[0] and np.array_equal(again["images"],
                                                      scene["images"])
    monkeypatch.setattr(tsynthetic, "MAX_TEACHER_DRAWS", 2)
    with pytest.raises(RuntimeError, match="holds density"):
        _scene_case(tsynthetic.make_scene, 16, 0)


# -- demo_synthetic, rd_sweep ---------------------------------------------
def test_demo_synthetic_on_cpu(tmp_path, on_cpu, capsys):
    out = tmp_path / "demo"
    result = demo_synthetic.main(["--hw", "8", "--iters", "2", "--out",
                                  str(out)])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == result
    assert set(result) == {"raw_bytes", "bitstream_bytes",
                           "compress_seconds", "psnr_teacher",
                           "psnr_quantized", "psnr_quantized_lsa"}
    # the student is the teacher: a saturated 8x8 view can render its
    # target exactly (PSNR inf), as in the reference; the quantized
    # students cannot, on a scene whose views hold density
    assert not np.isnan([result[k] for k in result]).any()
    assert np.isfinite([result["psnr_quantized"],
                        result["psnr_quantized_lsa"]]).all()
    import nnc_tpu_torch
    streams = [str(p) for p in out.rglob("*.nnc")]
    assert len(streams) == 2
    for bs in streams:
        rec = nnc_tpu_torch.decompress(bs, verbose=False)
        assert len(rec) == 48 and all(np.isfinite(v).all()
                                      for v in rec.values())
    assert list(out.rglob("*_reconstructed.tar"))


def test_rd_sweep_synthetic_on_cpu(tmp_path, on_cpu):
    out = tmp_path / "rd"
    rd_sweep.main(["--synthetic", "--qps", "-20", "--lsa-iters", "2",
                   "--out", str(out)])
    with open(out / "rd_results.json") as f:
        recs = json.load(f)
    with open(os.path.join(REPO, "rd_results.json")) as f:
        ref_fields = {tuple(sorted(r)) for r in json.load(f)
                      if "psnr_holdout" not in r}
    assert [(r["qp"], r["lsa"], r["mode"]) for r in recs] == \
        [(-20, False, "flat"), (-20, True, "flat")]
    for r in recs:
        assert (tuple(sorted(r)),) == tuple(ref_fields)
        assert r["scene"] == "synthetic" and r["lsa_iters"] == 2
        assert r["bytes"] > 0 and np.isfinite(r["psnr"])
        assert os.path.exists(os.path.join(r["run_dir"], "bitstream",
                                           "bitstream.nnc"))
    assert recs[1]["psnr"] >= recs[0]["psnr"], "LSA lost PSNR"
    assert (out / "rd_curve.png").exists() == \
        (importlib.util.find_spec("matplotlib") is not None)


# -- profile_codec ---------------------------------------------------------
def test_profile_codec_round_trips(capsys):
    """The dequantized values equal the codec's reconstruction of the same
    bitstream (approximator.uniform_rec, which takes qp_density, qp and
    scan_order in order)."""
    rng = np.random.default_rng(0)
    sd = {"a.weight": rng.normal(0, 0.05, (64, 48)).astype(np.float32),
          "a.bias": rng.normal(0, 0.05, 64).astype(np.float32)}
    qp = -20
    best, est, nbytes, coded = profile_codec.profile(sd, qp, 2)
    assert set(best) == {"quant", "enc_opt", "enc_noopt", "decode",
                         "dequant"}
    assert nbytes == sum(bs.nbytes for bs, _ in coded.values()) > 0
    for name, v in sd.items():
        bs, values = coded[name]
        dec = cabac.Decoder()
        dec.setStream(bs)
        dec.initCtxModels(profile_codec.CULM1)
        ints = np.zeros(v.shape, np.int32)
        dec.decodeLayer(ints.reshape(v.shape[0], -1) if v.ndim > 1
                        else ints, 1, 0)
        data = {"parameters": {name: ints}, "qp": {name: qp},
                "qp_density": profile_codec.QP_DENSITY,
                "scan_order": {name: 0}, "dq_flag": {name: 1},
                "approx_method": {name: "uniform"}}
        approximator.uniform_rec(name, data)
        assert values.shape == v.shape
        assert np.array_equal(values, data["parameters"][name]), name
        step = cabac.stepsize_from_qp(qp, profile_codec.QP_DENSITY)
        assert np.abs(values - v).max() <= step
    result = profile_codec.main(["--reps", "1"])
    out = capsys.readouterr().out
    assert "encode total" in out and "decode total" in out
    assert result["raw_bytes"] == 4_766_752 and result["encode_mb_s"] > 0


# -- render_video, multi_scene ------------------------------------------------
@pytest.fixture
def small_grids(monkeypatch):
    """Grids at res 16: at 128 the full-width plain MLP sweeps 2.5 TFLOP."""
    build = occupancy.build_occupancy_grid
    monkeypatch.setattr(occupancy, "build_occupancy_grid",
                        lambda *a, **kw: build(*a, **dict(kw, res=16)))


@pytest.mark.parametrize("route", ["grid", "exact"])
def test_render_video_synthetic_on_cpu(tmp_path, on_cpu, small_grids,
                                       capsys, route):
    out = tmp_path / "video"
    argv = ["--synthetic", "--frames", "2", "--size", "16", "--out",
            str(out)] + (["--exact"] if route == "exact" else [])
    path = render_video.main(argv)
    assert path is not None and os.path.getsize(path) > 0
    assert sorted(p.name for p in out.glob("frame_*.png")) == \
        ["frame_000.png", "frame_001.png"]
    printed = capsys.readouterr().out
    assert ("occupancy grid built" in printed) == (route == "grid")


def test_multi_scene_synthetic_on_cpu(on_cpu, monkeypatch, capsys):
    steps = []
    update = lsa.Adam.update
    monkeypatch.setattr(lsa.Adam, "update", lambda self, *a: (
        steps.append(id(self)), update(self, *a))[1])
    psnrs = multi_scene.main(["--synthetic", "--n-scenes", "2", "--iters",
                              "2", "--n-rand", "32"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("{")]
    assert [ln["scene"] for ln in lines] == [0, 1]
    assert [ln["train_psnr"] for ln in lines] == psnrs
    assert np.isfinite(psnrs).all()
    # two scenes, each with its own optimizer, two steps each
    assert len(steps) == 4 and len(set(steps)) == 2
