"""The port's slice end to end against the JAX package (CPU).

1. render_rays with fused compositing, empty-ray culling and early
   termination, full width, 64 rays, 16+16 samples: max |drgb| < 5e-3 vs
   the JAX renderer (the bound of tests/test_mlp_pallas.py for the culled
   fused path against the exact one).
2. eval_model (IOQ's probe) and test_model of the two executers on scenes
   from nnc_tpu.data.synthetic: within 1e-3 dB. The scenes are 16x16 with
   32+32 samples: sample_pdf's ``denom < 1e-5`` switch makes the reference
   itself jump on last-bit changes of the weights, by up to 1.4 dB on an 8x8
   view with 8 coarse samples (one pixel, bins 0.5 wide) but by ~2e-4 dB
   here.
3. compress_model(ioq=True, lsa=False) through each executer: the decoded
   models' test PSNR within 0.1 dB (BASELINE.json's tolerance), with the
   same NDU unit layout.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import nnc_tpu
import nnc_tpu_torch
from nnc_tpu import coder
from nnc_tpu.data import synthetic as jsynthetic
from nnc_tpu.framework.executer import NeRFModelExecuter as JExecuter
from nnc_tpu.models import nerf as jnerf
from nnc_tpu.render import renderer as jrenderer
from nnc_tpu.train import presets as jpresets
from nnc_tpu_torch.framework.executer import NeRFModelExecuter as TExecuter
from nnc_tpu_torch.models import nerf as tnerf
from nnc_tpu_torch.render import renderer as trenderer
from nnc_tpu_torch.train import presets as tpresets

MLP_J = jnerf.NeRFConfig(W=32)


def test_render_rays_fused_culled_matches_jax():
    cfg = jnerf.NeRFConfig()
    params = jsynthetic._activate(
        jnerf.init_params(jax.random.PRNGKey(0), cfg), 3)
    params_f = jsynthetic._activate(
        jnerf.init_params(jax.random.PRNGKey(1), cfg), 4)
    np_tree = lambda p: jax.tree.map(np.asarray, p)
    model = tnerf.from_jax_params(np_tree(params), tnerf.NeRFConfig())
    model_f = tnerf.from_jax_params(np_tree(params_f), tnerf.NeRFConfig())

    rng = np.random.default_rng(6)
    R = 64
    ro = (0.1 * rng.standard_normal((R, 3))).astype(np.float32)
    rd = (0.2 * rng.standard_normal((R, 3)) + [0, 0, -1.0]).astype(np.float32)
    rd[::3] = [0.0, 0.0, 1.0]  # looking away from the fog: empty rays
    vd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)

    common = dict(n_samples=16, n_importance=16, perturb=False,
                  use_fused_mlp=True, use_fused_compositing=True,
                  early_term_eps=1e-4, empty_ray_eps=1e-3)
    rc_j = jrenderer.RenderConfig(mlp=cfg, **common)
    rc_t = trenderer.RenderConfig(mlp=tnerf.NeRFConfig(), **common)
    want = jrenderer.render_rays(params, params_f, None, None,
                                 jnp.asarray(ro), jnp.asarray(rd),
                                 jnp.asarray(vd), 2.0, 6.0,
                                 jax.random.PRNGKey(9), rc_j,
                                 deterministic=True)
    t = torch.from_numpy
    with torch.no_grad():
        got = trenderer.render_rays(model, model_f, t(ro), t(rd), t(vd), 2.0,
                                    6.0, rc_t, deterministic=True)
        exact = trenderer.render_rays(
            model, model_f, t(ro), t(rd), t(vd), 2.0, 6.0,
            trenderer.RenderConfig(mlp=tnerf.NeRFConfig(), n_samples=16,
                                   n_importance=16, perturb=False),
            deterministic=True)
    for k in ("rgb_map", "rgb0"):
        d = np.abs(got[k].numpy() - np.asarray(want[k]))
        assert d.max() < 5e-3, (k, d.max())
        d = np.abs(got[k].numpy() - exact[k].numpy())
        assert d.max() < 5e-3, (k, d.max())
    np.testing.assert_allclose(got["acc_map"].numpy(),
                               np.asarray(want["acc_map"]), atol=5e-3)


HW, N_SAMPLES, N_IMPORTANCE = 16, 32, 32


def _scene(kind):
    rc = jrenderer.RenderConfig(mlp=MLP_J, n_samples=8, n_importance=4,
                                chunk=HW * HW)
    if kind == "inward":
        scene, teachers = jsynthetic.make_scene(n_images=3, H=HW, W=HW,
                                                mlp=MLP_J, rc=rc)
    else:
        scene, teachers = jsynthetic.make_scene_ndc(n_images=3, H=HW, W=HW,
                                                    mlp=MLP_J, rc=rc)
        scene["raw_noise_std"] = 1.0
    scene["n_importance"] = N_IMPORTANCE
    sd = {}
    sd.update(jnerf.params_to_state_dict(teachers[0], "model."))
    sd.update(jnerf.params_to_state_dict(teachers[1], "model_fine."))
    return scene, sd


def _executers(scene):
    """The JAX executer renders chunks padded to ``chunk`` rays: keep it at
    the scene's pixel count so the IOQ probes stay cheap on the CPU."""
    rc_j = jpresets.make_render_config(scene, MLP_J, chunk=HW * HW,
                                       use_fused_mlp=True,
                                       n_samples=N_SAMPLES)
    ex_j = JExecuter(scene, rc_j, verbose=False)
    ex_t = tpresets.create_nerf_model_executer(
        scene=scene, device="cpu", mlp_config=tnerf.NeRFConfig(W=32),
        use_fused_mlp=True, n_samples=N_SAMPLES, verbose=False)
    return ex_j, ex_t


@pytest.mark.parametrize("kind", ["inward", "ndc"])
def test_eval_and_test_model_match_jax(kind):
    scene, sd = _scene(kind)
    ex_j, ex_t = _executers(scene)
    assert isinstance(ex_t, TExecuter)
    ev_j, ev_t = ex_j.eval_model(sd), ex_t.eval_model(sd)
    assert abs(ev_t[0] - ev_j[0]) < 1e-3, (ev_t, ev_j)
    assert ev_t[0] == ex_t.eval_model(sd)[0]  # the same batch every call
    te_j, te_t = ex_j.test_model(sd), ex_t.test_model(sd)
    assert abs(te_t - te_j) < 1e-3, (te_t, te_j)
    assert np.isfinite(te_t) and te_t > 15


@pytest.mark.parametrize("case", ["int8", "posenc"])
def test_executers_render_int8_and_other_posenc_routes(case):
    """The render options that the port refused before it had K-B4 and K-B5
    are passing renders now: ``use_int8_mlp``, and ``use_fused_mlp`` with a
    posenc other than 10/4. At W=32 neither package has a kernel for the
    architecture, so both end in their plain MLP: within 1e-3 dB."""
    if case == "int8":
        scene, sd = _scene("ndc")
        ex_j, ex_t = _executers(scene)
        change = dict(use_int8_mlp=True)
    else:
        mlp = jnerf.NeRFConfig(W=32, input_ch_views=3 + 6 * 2)
        change = dict(multires_views=2)
        rc = jrenderer.RenderConfig(mlp=mlp, n_samples=8, n_importance=4,
                                    chunk=HW * HW, **change)
        scene, teachers = jsynthetic.make_scene(n_images=3, H=HW, W=HW,
                                                mlp=mlp, rc=rc)
        scene["n_importance"] = N_IMPORTANCE
        sd = jnerf.params_to_state_dict(teachers[0], "model.")
        sd.update(jnerf.params_to_state_dict(teachers[1], "model_fine."))
        ex_j = JExecuter(scene, jpresets.make_render_config(
            scene, mlp, chunk=HW * HW, use_fused_mlp=True,
            n_samples=N_SAMPLES), verbose=False)
        ex_t = tpresets.create_nerf_model_executer(
            scene=scene, device="cpu",
            mlp_config=tnerf.NeRFConfig(W=32, input_ch_views=3 + 6 * 2),
            use_fused_mlp=True, n_samples=N_SAMPLES, verbose=False)
    ex_j.rc = dataclasses.replace(ex_j.rc, **change)
    ex_t.rc = dataclasses.replace(ex_t.rc, **change)
    te_j, te_t = ex_j.test_model(sd), ex_t.test_model(sd)
    assert abs(te_t - te_j) < 1e-3, (te_t, te_j)
    assert np.isfinite(te_t) and te_t > 15


def _layout(bitstream):
    model_info, ad = coder.decode(bitstream)
    return (sorted(ad["parameters"]), ad["approx_method"],
            model_info["block_identifier"])


def test_compress_ioq_matches_jax_executer(tmp_path):
    scene, sd = _scene("inward")
    ex_j, ex_t = _executers(scene)
    bs_j, bs_t = str(tmp_path / "jax.nnc"), str(tmp_path / "torch.nnc")
    nnc_tpu.compress_model(sd, bitstream_path=bs_j, qp=-20, ioq=True,
                           lsa=False, model_executer=ex_j, verbose=False)
    nnc_tpu_torch.compress_model(sd, bitstream_path=bs_t, qp=-20, ioq=True,
                                 lsa=False, scene=scene, use_fused_mlp=True,
                                 n_samples=N_SAMPLES, device="cpu",
                                 verbose=False)
    rec_j = nnc_tpu.decompress(bs_j, verbose=False)
    rec_t = nnc_tpu_torch.decompress(bs_t, verbose=False)
    assert set(rec_t) == set(rec_j) == set(sd)
    with open(bs_j, "rb") as f_j, open(bs_t, "rb") as f_t:
        assert _layout(f_t.read()) == _layout(f_j.read())
    psnr_j, psnr_t = ex_j.test_model(rec_j), ex_t.test_model(rec_t)
    assert abs(psnr_t - psnr_j) < 0.1, (psnr_t, psnr_j)


@pytest.mark.parametrize("kind", ["blender", "llff"])
def test_presets_match_jax(tmp_path, kind):
    """Scenes from the shared loaders and the render presets, both packages:
    identical scene dicts and RenderConfig fields."""
    from test_data_loaders import make_blender_tree, make_llff_tree
    (make_blender_tree if kind == "blender" else make_llff_tree)(
        str(tmp_path))
    kw = {"half_res": False, "testskip": 1} if kind == "blender" \
        else {"factor": 2}
    want = jpresets.load_scene(kind, str(tmp_path), **kw)
    got = tpresets.load_scene(kind, str(tmp_path), **kw)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    rc_j = jpresets.make_render_config(want, use_fused_mlp=True)
    rc_t = tpresets.make_render_config(got, use_fused_mlp=True)
    for f in dataclasses.fields(rc_j):
        if f.name != "mlp":
            assert getattr(rc_t, f.name) == getattr(rc_j, f.name), f.name
    cfg = tmp_path / "scene.txt"
    cfg.write_text(f"dataset_type = {kind}\nwhite_bkgd = False\n"
                   "N_importance = 32\n")
    scene_j, ov_j = jpresets.load_scene_from_config(str(cfg), str(tmp_path))
    scene_t, ov_t = tpresets.load_scene_from_config(str(cfg), str(tmp_path))
    assert ov_t == ov_j
    assert (scene_t["white_bkgd"], scene_t["n_importance"]) == \
        (scene_j["white_bkgd"], scene_j["n_importance"])


@pytest.mark.parametrize("kind", ["deepvoxels", "LINEMOD"])
def test_presets_load_deepvoxels_and_linemod_like_jax(tmp_path, monkeypatch,
                                                      kind):
    """The two loaders the port copies (data/deepvoxels.py, data/linemod.py)
    and their load_scene branches, on fixture trees made as
    tests/test_data_loaders.py makes them: identical scene dicts and render
    presets."""
    from test_data_loaders import make_deepvoxels_tree, make_linemod_tree
    monkeypatch.setenv("NNC_TPU_DV_SHAPE", "cube")
    if kind == "deepvoxels":
        make_deepvoxels_tree(str(tmp_path), n=2, size=512)
        kw = {"testskip": 1}
    else:
        make_linemod_tree(str(tmp_path))
        kw = {"half_res": False, "testskip": 1}
    want = jpresets.load_scene(kind, str(tmp_path), **kw)
    got = tpresets.load_scene(kind, str(tmp_path), **kw)
    assert set(got) == set(want) and got["dataset_type"] == kind
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=k)
    rc_j = jpresets.make_render_config(want)
    rc_t = tpresets.make_render_config(got)
    for f in dataclasses.fields(rc_j):
        if f.name != "mlp":
            assert getattr(rc_t, f.name) == getattr(rc_j, f.name), f.name


def _recorded_grids(monkeypatch):
    """The port's occupancy grids built at res 16; their dilations are
    recorded."""
    from nnc_tpu_torch.render import occupancy as tocc
    built, orig = [], tocc.build_occupancy_grid

    def small(*a, **kw):
        built.append(kw.get("dilate", 3))
        return orig(*a, **{**kw, "res": 16})

    monkeypatch.setattr(tocc, "build_occupancy_grid", small)
    return built


def test_compress_model_runs_occupancy_stages(tmp_path, monkeypatch):
    """Both occupancy flags run through compress_model(lsa=True) on the
    CPU: the flagship's executer tunes on a grid built with dilate 1 and
    renders its i_save views through grids built with dilate 3
    (tests/test_torch_port_occupancy.py holds the mode against the
    reference); the narrow net has no kernel, so it renders and tunes
    exactly, as in the reference. LSA and fine-tuning are ported
    (tests/test_torch_port_train.py), and so is a device mesh
    (tests/test_torch_port_parallel.py)."""
    from nnc_tpu_torch.data import synthetic as tsynthetic
    built = _recorded_grids(monkeypatch)
    flags = dict(occupancy_renders=True, occupancy_tuning=True, lsa=True,
                 device="cpu", verbose=False, N_iters=1, epochs=1,
                 N_rand=16)
    mlp = tnerf.NeRFConfig()
    rc = trenderer.RenderConfig(mlp=mlp, n_samples=8, n_importance=4,
                                chunk=64)
    scene, teachers = tsynthetic.make_scene(n_images=2, H=8, W=8, mlp=mlp,
                                            rc=rc, seed=3)
    sd = tnerf.params_to_state_dict(teachers[0], "model.")
    sd.update(tnerf.params_to_state_dict(teachers[1], "model_fine."))
    (tmp_path / "flagship" / "bitstream").mkdir(parents=True)
    nnc_tpu_torch.compress_model(
        sd, bitstream_path=str(tmp_path / "flagship" / "bitstream" / "x.nnc"),
        scene=scene, i_save=1, n_samples=8, n_importance=4, **flags)
    assert built[0] == 1 and len(built) > 1 and set(built[1:]) == {3}
    assert len(list((tmp_path / "flagship" / "testset_step1")
                    .glob("*.png"))) == len(scene["i_test"])

    scene, sd = _scene("inward")
    n_built = len(built)
    nnc_tpu_torch.compress_model(
        sd, bitstream_path=str(tmp_path / "x.nnc"), scene=scene, i_save=0,
        **flags)
    assert len(built) == n_built
    _ex_j, ex_t = _executers(scene)
    assert ex_t.has_tune_lsa() and ex_t.has_tune_ft()
