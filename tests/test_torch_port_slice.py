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


def test_compress_model_refuses_unported_stages(tmp_path):
    scene, sd = _scene("inward")
    for kw in ({"lsa": True}, {"fine_tune": True},
               {"occupancy_renders": True}):
        with pytest.raises(NotImplementedError):
            nnc_tpu_torch.compress_model(
                sd, bitstream_path=str(tmp_path / "x.nnc"), ioq=True,
                scene=scene, device="cpu", verbose=False, **kw)
    _ex_j, ex_t = _executers(scene)
    assert not ex_t.has_tune_lsa() and not ex_t.has_tune_ft()
    with pytest.raises(NotImplementedError, match="B1"):
        ex_t.tune_model(None, sd, None)
