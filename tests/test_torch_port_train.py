"""LSA tuning in nnc_tpu_torch against nnc_tpu (CPU, float32).

Inputs are made with numpy from a seed and given to both packages; the JAX
package's random draws are replayed into the port's ``draws``. Tolerances:
  (a) K-B1's plain forward vs the Pallas pair (interpret mode), flagship
      width: the loss to rtol 1e-5 (tests/test_mlp_train_pallas.py's bar);
  (b, c) its plain backward through the autograd.Function vs jax.grad of
      the Pallas op and vs torch autograd of the plain MLP: the criterion of
      tests/test_mlp_train_pallas.py:41-50 (99.9% of the elements within
      rtol 5e-2 / atol 5e-3 of the gradient's max, none off by 5% of it);
  (d) scale and bias gradients of one batch of double_mse_loss: rtol 1e-4
      with atol 1e-4 of the gradient's max (W=32: the JAX MLP folds the
      scales into W, the port scales the outputs, so products round
      differently); the flagship batch through both kernel pairs by (b)'s
      criterion;
  (e) an LSA trajectory: scales to rtol 2e-4 / atol 2e-6 and the mean PSNR
      to 0.05 dB (tests/test_multi_scene.py's bar);
  (g) compress_model(lsa / fine_tune) through each executer: decoded test
      PSNR within 0.1 dB (BASELINE.json's tolerance), the same NDU layout.
"""
import os
import subprocess
import sys
import zlib

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
from nnc_tpu.ops import mlp_train_pallas
from nnc_tpu.render import renderer as jrenderer
from nnc_tpu.train import lsa as jlsa
from nnc_tpu.train import presets as jpresets
from nnc_tpu.utils import ckpt as cku
from nnc_tpu_torch import compress_nerf as tcli
from nnc_tpu_torch.data import synthetic as tsynthetic
from nnc_tpu_torch.models import nerf as tnerf
from nnc_tpu_torch.ops import mlp_train_fused
from nnc_tpu_torch.ops.posenc import positional_encoding as tposenc
from nnc_tpu_torch.render import mipnerf as tmipnerf
from nnc_tpu_torch.render import occupancy as tocc
from nnc_tpu_torch.render import renderer as trenderer
from nnc_tpu_torch.train import lsa as tlsa
from nnc_tpu_torch.train import presets as tpresets
from nnc_tpu_torch.utils.images import png_bytes, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MLP_J = jnerf.NeRFConfig(W=32)
MLP_T = tnerf.NeRFConfig(W=32)
# 32+32 samples: sample_pdf's ``denom < 1e-5`` switch jumps on last-bit
# changes of the weights, by up to 1.4 dB on an 8x8 view with 8 coarse
# samples but ~2e-4 dB at 32 (ROADMAP C, tests/test_torch_port_slice.py)
N_SAMPLES = 32


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _grads_close(got, want, msg):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-12)
    close = np.isclose(got, want, rtol=5e-2, atol=5e-3 * scale)
    assert close.mean() > 0.999, (msg, 1 - close.mean())
    assert np.abs(got - want).max() < 0.05 * scale, (msg, scale)


@pytest.fixture(scope="module")
def flagship():
    """Full-width weights and LSA scales (std 0.05) as numpy, the JAX
    pytrees of them and the port's model."""
    cfg = jnerf.NeRFConfig()
    params = _np_tree(jnerf.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(5)
    ls = {name: (1.0 + 0.05 * rng.standard_normal(p["b"].shape[0]))
          .astype(np.float32) for name, p in params.items()}
    model = tnerf.from_jax_params(params, tnerf.NeRFConfig(), ls=ls)
    return (cfg, jax.tree.map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in ls.items()}, model)


def _points(n, seed=1):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    vd = rng.standard_normal((n, 3)).astype(np.float32)
    tgt = rng.standard_normal((n, 4)).astype(np.float32)
    return pts, vd, tgt


def _jax_loss(ls, params, pts, vd, tgt, cfg, with_dw=False):
    raw = mlp_train_pallas.fused_nerf_mlp_train(params, ls, pts, vd, cfg,
                                                with_dw=with_dw)
    return jnp.mean((raw - tgt) ** 2)


def _set_grad(model, weights):
    for layer in model.layers().values():
        layer.weight.requires_grad_(weights)
        layer.bias.requires_grad_(True)
        layer.weight_scaling.requires_grad_(True)
        layer.weight.grad = layer.bias.grad = layer.weight_scaling.grad = None


def _torch_grads(model):
    return {n: (None if l.weight.grad is None else l.weight.grad.numpy().T,
                l.bias.grad.numpy(), l.weight_scaling.grad.numpy().ravel())
            for n, l in model.layers().items()}


# (a) -----------------------------------------------------------------------
@pytest.mark.parametrize("n", [mlp_train_pallas.TILE,
                               mlp_train_pallas.TILE + 17])
def test_train_forward_matches_pallas(flagship, n):
    cfg, jparams, jls, model = flagship
    pts, vd, tgt = _points(n)
    want = float(_jax_loss(jls, jparams, jnp.asarray(pts), jnp.asarray(vd),
                           jnp.asarray(tgt), cfg))
    tensors = mlp_train_fused._layer_tensors(model)
    params, _, ls = mlp_train_fused.pack_train(tensors[0::3], tensors[1::3],
                                               tensors[2::3])
    raw = mlp_train_fused.mlp_train_fwd_plain(
        params, ls, torch.from_numpy(pts), torch.from_numpy(vd))
    got = float(torch.mean((raw - torch.from_numpy(tgt)) ** 2))
    np.testing.assert_allclose(got, want, rtol=1e-5)


# (b) -----------------------------------------------------------------------
@pytest.mark.parametrize("with_dw", [False, True])
def test_train_backward_matches_pallas(flagship, with_dw):
    """dls and db always; dW with with_dw, else an exact zero dW beside a
    real db (fine-tuning trains biases through this path)."""
    cfg, jparams, jls, model = flagship
    pts, vd, tgt = _points(mlp_train_pallas.TILE, seed=2)
    g_ls, g_p = jax.grad(_jax_loss, argnums=(0, 1))(
        jls, jparams, jnp.asarray(pts), jnp.asarray(vd), jnp.asarray(tgt),
        cfg, with_dw)
    _set_grad(model, True)
    raw = mlp_train_fused.fused_nerf_mlp_train(
        model, torch.from_numpy(pts), torch.from_numpy(vd), with_dw=with_dw)
    torch.mean((raw - torch.from_numpy(tgt)) ** 2).backward()
    got = _torch_grads(model)
    for name in g_ls:
        gw, gb, gl = got[name]
        _grads_close(gl, g_ls[name], f"{name} ls")
        _grads_close(gb, g_p[name]["b"], f"{name} b")
        if with_dw:
            _grads_close(gw, g_p[name]["w"], f"{name} w")
        else:
            assert np.abs(gw).max() == 0.0
            assert float(jnp.abs(g_p[name]["w"]).max()) == 0.0


# (c) -----------------------------------------------------------------------
def test_train_backward_matches_torch_autograd(flagship):
    _cfg, _jp, _jl, model = flagship
    pts, vd, tgt = (torch.from_numpy(a) for a in _points(700, seed=3))
    _set_grad(model, True)
    raw = mlp_train_fused.fused_nerf_mlp_train(model, pts, vd, with_dw=True)
    torch.mean((raw - tgt) ** 2).backward()
    got = _torch_grads(model)
    _set_grad(model, True)
    want_raw = tnerf.apply_mlp(model, tposenc(pts, 10), tposenc(vd, 4),
                               output_scaling=True)
    torch.mean((want_raw - tgt) ** 2).backward()
    want = _torch_grads(model)
    np.testing.assert_allclose(raw.detach().numpy(),
                               want_raw.detach().numpy(), atol=1e-5)
    for name in want:
        for part, g, w in zip(("w", "b", "ls"), got[name], want[name]):
            _grads_close(g, w, f"{name} {part}")
    _set_grad(model, False)


def test_non_flagship_takes_the_plain_mlp():
    model = tnerf.init_params(MLP_T, torch.Generator().manual_seed(0))
    pts = torch.randn(5, 7, 3)
    vd = torch.randn(5, 1, 3)
    raw = mlp_train_fused.fused_nerf_mlp_train(model, pts, vd)
    want = tnerf.apply_mlp(model, tposenc(pts, 10),
                           tposenc(vd.expand_as(pts), 4))
    assert raw.shape == (5, 7, 4)
    np.testing.assert_allclose(raw.detach().numpy(), want.detach().numpy(),
                               atol=1e-6)


# (d) -----------------------------------------------------------------------
def _jax_draws(key, R, rc):
    """The draws render_rays takes from ``key`` (renderer.py:119,
    sampling.py:28,54, volume.py:29), as torch tensors."""
    k_strat, k_pdf, k_n0, k_n1 = jax.random.split(key, 4)
    S = rc.n_samples + rc.n_importance
    t = lambda a: torch.from_numpy(np.array(a))
    return {"t_rand": t(jax.random.uniform(k_strat, (R, rc.n_samples))),
            "u": t(jax.random.uniform(k_pdf, (R, rc.n_importance))),
            "noise0": t(jax.random.normal(k_n0, (R, rc.n_samples))),
            "noise1": t(jax.random.normal(k_n1, (R, S)))}


def _batch(R, seed):
    rng = np.random.default_rng(seed)
    ro = (0.1 * rng.standard_normal((R, 3)) + [0, 0, 4.0]).astype(np.float32)
    rd = (0.3 * rng.standard_normal((R, 3)) + [0, 0, -1.0]) \
        .astype(np.float32)
    vd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    tgt = rng.uniform(size=(R, 3)).astype(np.float32)
    return ro, rd, vd, tgt


def _loss_grads_both(cfg_j, cfg_t, params, ls, rc_kw, R, fused):
    """Scale and bias grads of one double_mse_loss batch, both packages."""
    rc_j = jrenderer.RenderConfig(mlp=cfg_j, use_fused_train=fused, **rc_kw)
    rc_t = trenderer.RenderConfig(mlp=cfg_t, use_fused_train=fused, **rc_kw)
    ro, rd, vd, tgt = _batch(R, 4)
    key = jax.random.PRNGKey(3)
    (pc, pf), (lc, lf) = params, ls
    scales = {"ls": tuple(jax.tree.map(jnp.asarray, x) for x in (lc, lf)),
              "b": tuple({n: jnp.asarray(p["b"]) for n, p in x.items()}
                         for x in (pc, pf))}
    g = jax.grad(lambda s: jlsa.double_mse_loss(
        s, tuple(jax.tree.map(jnp.asarray, x) for x in (pc, pf)),
        jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(vd), jnp.asarray(tgt),
        2.0, 6.0, key, rc_j)[0])(scales)
    mc = tnerf.from_jax_params(pc, cfg_t, ls=lc)
    mf = tnerf.from_jax_params(pf, cfg_t, ls=lf)
    tlsa.trained_tensors(mc, mf, tune_scales=True, tune_biases=True)
    t = torch.from_numpy
    loss, _ = tlsa.double_mse_loss(mc, mf, t(ro), t(rd), t(vd), t(tgt), 2.0,
                                   6.0, rc_t, draws=_jax_draws(key, R, rc_t))
    loss.backward()
    pairs = []
    for m, gl, gb in zip((mc, mf), g["ls"], g["b"]):
        for name, layer in m.layers().items():
            pairs.append((f"{name} ls", layer.weight_scaling.grad.numpy()
                          .ravel(), np.asarray(gl[name])))
            pairs.append((f"{name} b", layer.bias.grad.numpy(),
                          np.asarray(gb[name])))
    return pairs


def _fog(cfg, seed):
    return _np_tree(jsynthetic._activate(
        jnerf.init_params(jax.random.PRNGKey(seed), cfg), seed + 3))


def test_double_mse_loss_grads_match_jax():
    rng = np.random.default_rng(9)
    params = (_fog(MLP_J, 0), _fog(MLP_J, 1))
    ls = tuple({n: (1 + 0.05 * rng.standard_normal(p["b"].shape[0]))
                .astype(np.float32) for n, p in P.items()} for P in params)
    pairs = _loss_grads_both(MLP_J, MLP_T, params, ls,
                             dict(n_samples=16, n_importance=16,
                                  raw_noise_std=1.0, white_bkgd=True), 48,
                             fused=False)
    for what, got, want in pairs:
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=what)


def test_double_mse_loss_grads_match_jax_flagship_fused():
    """One 8-ray batch with use_fused_train on both sides: the port's K-B1
    (plain versions) against the Pallas pair in interpret mode."""
    cfg = jnerf.NeRFConfig()
    params = (_fog(cfg, 0), _fog(cfg, 1))
    ls = tuple({n: np.ones(p["b"].shape[0], np.float32)
                for n, p in P.items()} for P in params)
    pairs = _loss_grads_both(cfg, tnerf.NeRFConfig(), params, ls,
                             dict(n_samples=16, n_importance=16), 8,
                             fused=True)
    for what, got, want in pairs:
        _grads_close(got, want, what)


# (e) -----------------------------------------------------------------------
@pytest.mark.parametrize("kind, points", [("exact", 8 + 16),
                                          ("occupancy", 2 * 8),
                                          ("mip", 2 * 8)])
def test_route_draws_pair_with_its_loss(kind, points):
    """A route's loss on its draws equals its loss drawing from a generator
    seeded the same; its MLP points a ray are those that the LSA call's
    span counts (tests/test_torch_port_spans.py, 8 + (8 + 8) samples;
    tests/test_torch_port_mipnerf.py, 2 levels of 8)."""
    g = torch.Generator().manual_seed(0)
    grid = None
    if kind == "mip":
        mlp = tnerf.NeRFConfig(W=32, input_ch=96, input_ch_views=27)
        rc = tmipnerf.MipRenderConfig(mlp=mlp, num_samples=8)
        models = (tnerf.init_params(mlp, g), None)
    else:
        rc = trenderer.RenderConfig(mlp=MLP_T, n_samples=8, n_importance=8,
                                    raw_noise_std=0.5)
        models = (tnerf.init_params(MLP_T, g), tnerf.init_params(MLP_T, g))
        if kind == "occupancy":
            grid = tocc.grid_from_arrays(np.ones((8, 8, 8), bool),
                                         (-2.0,) * 3, (2.0,) * 3)
    route = tlsa.route(rc, grid, n_candidates=16, budget=8)
    assert route.points_per_ray == points
    assert route.networks == (1 if kind == "mip" else 2)
    args = (*models, *map(torch.from_numpy, _batch(16, 5)), 2.0, 6.0, rc)
    drawn = route.draws(16, torch.Generator().manual_seed(7),
                        torch.device("cpu"))
    assert drawn
    got = route.loss(*args, draws=drawn)
    want = route.loss(*args, generator=torch.Generator().manual_seed(7))
    assert all(torch.equal(a, b) for a, b in zip(got, want)), (got, want)


def test_route_refuses_mip_on_a_grid():
    grid = tocc.grid_from_arrays(np.ones((8, 8, 8), bool), (-2.0,) * 3,
                                 (2.0,) * 3)
    with pytest.raises(ValueError, match="one network"):
        tlsa.route(tmipnerf.MipRenderConfig(), grid)


def test_lr_schedule_matches_jax():
    for decay, offset in ((0.5, 0), (0.1, 7), (0.0, 3)):
        want = jlsa.make_lr_schedule(1e-3, decay, 5, offset=offset)
        got = tlsa.make_lr_schedule(1e-3, decay, 5, offset=offset)
        for count in range(23):
            w = want(count) if callable(want) else want
            assert got(count) == pytest.approx(float(w), rel=1e-12)


def _scene(kind, n_importance=32):
    rc = jrenderer.RenderConfig(mlp=MLP_J, n_samples=8, n_importance=4,
                                chunk=16 * 16)
    make = jsynthetic.make_scene if kind == "inward" \
        else jsynthetic.make_scene_ndc
    scene, teachers = make(n_images=3, H=16, W=16, mlp=MLP_J, rc=rc)
    if kind == "ndc":
        scene["raw_noise_std"] = 1.0
    scene["n_importance"] = n_importance
    sd = {}
    sd.update(jnerf.params_to_state_dict(teachers[0], "model."))
    sd.update(jnerf.params_to_state_dict(teachers[1], "model_fine."))
    return scene, sd


def _move_in(scene):
    """Cameras in to radius 1.2 (near 0.6, far 1.8; the targets stay those
    of radius 4). At radius 4 the points reach ~6 from the origin, and JAX's
    jitted LSA step and its eager render of the same batch already differ
    by 7e-5 in the first loss, where the port agrees with the eager render
    to 6e-6."""
    scene["poses"] = scene["poses"].copy()
    scene["poses"][:, :3, 3] *= 0.3
    scene["near"], scene["far"] = 0.6, 1.8
    return scene


def _jax_step_keys(n, seed=451):
    """The keys of JAX's tune_lsa_scales(steps_per_call=1), step by step."""
    key, keys = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        keys.append(sub)
    return keys


def _perturbed(sd, seed):
    """The teacher with 5% multiplicative noise on every weight: something
    for LSA to correct."""
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) * (1 + 0.05 * rng.standard_normal(
        np.shape(v))) if k.endswith(".weight") else np.asarray(v))
        .astype(np.float32) for k, v in sd.items()}


def _executers(scene, **kw):
    rc_j = jpresets.make_render_config(scene, MLP_J, chunk=16 * 16,
                                       n_samples=N_SAMPLES)
    ex_j = JExecuter(scene, rc_j, verbose=False, **kw)
    return ex_j, _torch_executer(scene, **kw)


def _torch_executer(scene, **kw):
    return tpresets.create_nerf_model_executer(
        scene=scene, device="cpu", mlp_config=MLP_T, n_samples=N_SAMPLES,
        verbose=False, **kw)


@pytest.mark.parametrize("kind", ["inward", "ndc"])
def test_tune_lsa_trajectory_matches_jax(kind):
    """Six Adam steps over two epochs (the lr halves after three), the same
    batches, JAX's keys replayed; inward cameras moved in (_move_in)."""
    scene, sd = _scene(kind)
    if kind == "inward":
        _move_in(scene)
    sd = _perturbed(sd, 1)
    kw = dict(learning_rate=5e-3, epochs=2, n_iters=3,
              learning_rate_decay=0.5, n_rand=32)
    ex_j, ex_t = _executers(scene, **kw)
    pc, pf, lc, lf = ex_j._split_params(sd)
    want = jlsa.tune_lsa_scales(
        pc, pf, lc, lf, ex_j._make_batcher(), ex_j.rc, scene["near"],
        scene["far"], learning_rate=5e-3, learning_rate_decay=0.5, epochs=2,
        n_iters=3, seed=451, verbose=False, steps_per_call=1)

    keys = _jax_step_keys(6)
    mc, mf = ex_t._split_params(sd)
    got = tlsa.tune_lsa_scales(
        mc, mf, ex_t._make_batcher(), ex_t.rc, scene["near"], scene["far"],
        learning_rate=5e-3, learning_rate_decay=0.5, epochs=2, n_iters=3,
        seed=451, verbose=False,
        draws=lambda i: _jax_draws(keys[i], 32, ex_t.rc))
    assert got[4] == want[4] == 6
    moved = 0.0
    for g_ls, w_ls in zip(got[:2], want[:2]):
        for name in w_ls:
            w = np.asarray(w_ls[name])
            moved = max(moved, np.abs(w - 1).max())
            np.testing.assert_allclose(g_ls[name].numpy(), w, rtol=2e-4,
                                       atol=2e-6, err_msg=name)
    assert moved > 1e-2
    assert abs(got[2] - want[2]) < 0.05


# (f) -----------------------------------------------------------------------
def test_tune_model_artifacts_and_resume(tmp_path, capsys, monkeypatch):
    scene, sd = _scene("inward", n_importance=8)
    sd = _perturbed(sd, 2)
    ex_t = _torch_executer(scene, learning_rate=1e-2, epochs=2, n_iters=2,
                           i_save=2, n_rand=16)
    ex_t.verbose = True
    bs = tmp_path / "run" / "bitstream" / "x.nnc"
    bs.parent.mkdir(parents=True)
    lsa_p, ft_p = ex_t.tune_model(str(bs), sd, None, lsa_flag=True,
                                  ft_flag=True)
    assert sorted(lsa_p) == sorted(k[:-len(".weight")] + ".weight_scaling"
                                   for k in sd if k.endswith(".weight"))
    assert sorted(ft_p) == sorted(k for k in sd if k.endswith(".bias"))
    for k, v in ft_p.items():
        assert v.shape == np.shape(sd[k])
    run = tmp_path / "run"
    rec = run / "reconstructed"
    assert sorted(p.name for p in rec.iterdir()) == sorted(
        f"ckpt_step{s}{ext}" for s in (1, 2, 4) for ext in (".pt", ".opt.pt"))
    pngs = sorted(p.name for p in (run / "testset_step4").iterdir())
    assert pngs == [f"{i:03d}.png" for i in scene["i_test"]]
    assert (run / "result.txt").exists()
    ck = torch.load(rec / "ckpt_step4.pt", weights_only=True)
    np.testing.assert_allclose(
        ck["model.pts_linears.3.weight_scaling"].numpy().ravel(),
        lsa_p["model.pts_linears.3.weight_scaling"])
    assert torch.load(rec / "ckpt_step4.opt.pt",
                      weights_only=True)["count"] == 4

    # resume: scales, fine-tuned biases, step counter and Adam moments
    # continue from step 4
    ex_t.resume = True
    capsys.readouterr()
    start = {}
    tune = tlsa.tune_lsa_scales

    def spy(model_c, model_f, *a, **k):
        for prefix, model in (("model.", model_c), ("model_fine.", model_f)):
            for name, layer in model.layers().items():
                start[prefix + name] = (layer.weight_scaling.detach().clone(),
                                        layer.bias.detach().clone())
        return tune(model_c, model_f, *a, **k)

    monkeypatch.setattr(tlsa, "tune_lsa_scales", spy)
    ex_t.tune_model(str(bs), sd, None, lsa_flag=True, ft_flag=True)
    for key, (ls, b) in start.items():
        np.testing.assert_array_equal(
            ls.numpy().ravel(), ck[key + ".weight_scaling"].numpy().ravel())
        np.testing.assert_array_equal(b.numpy(), ck[key + ".bias"].numpy())
        np.testing.assert_array_equal(b.numpy(), ft_p[key + ".bias"])
    assert any(np.abs(ft_p[k] - np.asarray(sd[k])).max() > 0 for k in ft_p)
    assert "resuming LSA from step 4" in capsys.readouterr().out
    assert (rec / "ckpt_step8.pt").exists()
    assert torch.load(rec / "ckpt_step8.opt.pt",
                      weights_only=True)["count"] == 8
    # a saved state that does not fit the tensors is dropped
    assert not tlsa.opt_state_fits(
        torch.load(rec / "ckpt_step8.opt.pt", weights_only=True),
        [torch.zeros(3)])


# (g) -----------------------------------------------------------------------
def _layout(path):
    with open(path, "rb") as f:
        model_info, ad = coder.decode(f.read())
    return (sorted(ad["parameters"]), ad["approx_method"],
            model_info["block_identifier"])


@pytest.mark.parametrize("flags", [dict(lsa=True),
                                   dict(lsa=False, fine_tune=True)])
def test_compress_lsa_matches_jax_executer(tmp_path, monkeypatch, flags):
    """Both executers tune through compress_model on the same batches, the
    port with JAX's draws replayed (tune_lsa_scales's ``draws``)."""
    scene, sd = _scene("inward")
    _move_in(scene)
    sd = _perturbed(sd, 3)
    kw = dict(learning_rate=1e-2, epochs=1, n_iters=4, i_save=0, n_rand=32)
    ex_j, ex_t = _executers(scene, **kw)
    keys = _jax_step_keys(4)
    tune = tlsa.tune_lsa_scales
    monkeypatch.setattr(tlsa, "tune_lsa_scales", lambda *a, **k: tune(
        *a, draws=lambda i: _jax_draws(keys[i], 32, ex_t.rc), **k))
    assert ex_t.has_tune_lsa() and ex_t.has_tune_ft()
    bs_j, bs_t = str(tmp_path / "jax.nnc"), str(tmp_path / "torch.nnc")
    nnc_tpu.compress_model(sd, bitstream_path=bs_j, qp=-20,
                           model_executer=ex_j, verbose=False, **flags)
    nnc_tpu_torch.compress_model(sd, bitstream_path=bs_t, qp=-20,
                                 model_executer=ex_t, verbose=False, **flags)
    layout = _layout(bs_t)
    assert layout == _layout(bs_j)
    assert any(k.endswith(".weight_scaling") for k in layout[0]) == \
        flags["lsa"]
    rec_j = nnc_tpu.decompress(bs_j, verbose=False)
    rec_t = nnc_tpu_torch.decompress(bs_t, verbose=False)
    assert set(rec_t) == set(rec_j) == set(sd)
    psnr_j, psnr_t = ex_j.test_model(rec_j), ex_t.test_model(rec_t)
    assert abs(psnr_t - psnr_j) < 0.1, (psnr_t, psnr_j)
    # the port's own executer, built from the arguments as the CLI builds it
    monkeypatch.undo()
    nnc_tpu_torch.compress_model(
        sd, bitstream_path=str(tmp_path / "own.nnc"), qp=-20, scene=scene,
        mlp_config=MLP_T, n_samples=8, N_iters=1, epochs=1, i_save=0,
        N_rand=16, device="cpu", verbose=False, **flags)
    assert _layout(str(tmp_path / "own.nnc")) == layout


# (h) -----------------------------------------------------------------------
def _actions(parser):
    return {a.dest: a for a in parser._actions}


def test_cli_flags_match_compress_nerf():
    import compress_nerf
    want, got = _actions(compress_nerf.build_parser()), \
        _actions(tcli.build_parser())
    assert set(got) == set(want)
    for dest, w in want.items():
        g = got[dest]
        for field in ("option_strings", "default", "choices", "help",
                      "required", "nargs"):
            assert getattr(g, field) == getattr(w, field), (dest, field)
        assert (g.type is None) == (w.type is None), dest
        if w.type in (int, float, str):
            assert g.type is w.type, dest
        elif w.type is not None:   # the boolean flags' parsers
            for text in ("true", "False", "1", "yes", "no", "0"):
                assert g.type(text) == w.type(text), (dest, text)


def test_cli_lsa_subprocess_on_cpu(tmp_path):
    from test_data_loaders import make_blender_tree
    data_dir = tmp_path / "blender"
    data_dir.mkdir()
    make_blender_tree(str(data_dir), n=2, size=16)
    g = torch.Generator().manual_seed(1)
    model = tsynthetic._activate(tnerf.init_params(tnerf.NeRFConfig(W=16),
                                                   g), g)
    sd = tnerf.params_to_state_dict(model, "model.")
    sd.update(tnerf.params_to_state_dict(model, "model_fine."))
    tar = str(tmp_path / "tiny_000002.tar")
    cku.wrapper_dict_to_nerf_tar(sd, tar, global_step=2)
    env = dict(os.environ, NNC_TPU_TORCH_DEVICE="cpu", PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-m", "nnc_tpu_torch.compress_nerf",
         "--ckpt_path", tar, "--ckpt_nickname", "tiny",
         "--base_path_to_save", str(tmp_path / "runs"),
         "--dataset_path", str(data_dir), "--dataset_type", "blender",
         "--qp", "-20", "--lsa", "true", "--epochs", "1",
         "--learning_rate", "0.05", "--N_iters", "2", "--i_save", "0",
         "--precrop_iters", "1", "--N_rand", "32", "--n_samples", "4",
         "--n_importance", "2"],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "will be disabled" not in out.stdout
    assert "Epoch done. mean PSNR" in out.stdout
    (run,) = list((tmp_path / "runs").iterdir())
    (rec_tar,) = list((run / "reconstructed").glob("*_reconstructed.tar"))
    wrapper, _ = cku.nerf_tar_to_wrapper_dict(str(rec_tar))
    assert set(wrapper) == set(sd)
    plain = nnc_tpu.decompress(nnc_tpu.compress(
        {k: np.asarray(v) for k, v in sd.items()}, bitstream_path=None,
        qp=-20, return_bitstream=True, verbose=False), verbose=False)
    assert max(float(np.abs(np.asarray(wrapper[k]) - plain[k]).max())
               for k in plain if k.endswith(".weight")) > 0.0


def test_cli_runs_occupancy(tmp_path, monkeypatch):
    """The CLI with --occupancy_renders true --occupancy_tuning true on a
    flagship checkpoint and a blender tree: one LSA step on the occupancy
    loss, the step's test views and spiral through the grid (its grids
    built at res 16 here), the bitstream and the reconstructed .tar."""
    from test_data_loaders import make_blender_tree
    from nnc_tpu_torch.render import occupancy as tocc
    built, orig = [], tocc.build_occupancy_grid
    monkeypatch.setattr(tocc, "build_occupancy_grid", lambda *a, **kw: (
        built.append(kw.get("dilate", 3)), orig(*a, **{**kw, "res": 16}))[1])
    data_dir = tmp_path / "blender"
    data_dir.mkdir()
    make_blender_tree(str(data_dir), n=2, size=16)
    g = torch.Generator().manual_seed(1)
    model = tsynthetic._activate(tnerf.init_params(tnerf.NeRFConfig(), g), g)
    sd = tnerf.params_to_state_dict(model, "model.")
    sd.update(tnerf.params_to_state_dict(model, "model_fine."))
    cku.wrapper_dict_to_nerf_tar(sd, str(tmp_path / "x.tar"))
    args = tcli.build_parser().parse_args(
        ["--ckpt_path", str(tmp_path / "x.tar"), "--ckpt_nickname", "x",
         "--base_path_to_save", str(tmp_path / "runs"),
         "--dataset_path", str(data_dir), "--occupancy_renders", "true",
         "--occupancy_tuning", "true", "--qp", "-20", "--lsa", "true",
         "--epochs", "1", "--N_iters", "1", "--i_save", "1",
         "--N_rand", "16", "--n_samples", "4", "--n_importance", "2",
         "--render_factor", "2"])
    monkeypatch.setenv("NNC_TPU_TORCH_DEVICE", "cpu")
    tcli.main(args)
    assert built[0] == 1 and len(built) == 3 and built[1:] == [3, 3]
    (run,) = list((tmp_path / "runs").iterdir())
    assert list((run / "bitstream").glob("*.nnc"))
    assert list((run / "testset_step1").glob("*.png"))
    (rec_tar,) = list((run / "reconstructed").glob("*_reconstructed.tar"))
    wrapper, _ = cku.nerf_tar_to_wrapper_dict(str(rec_tar))
    assert set(wrapper) == set(sd)


# PNG writer -----------------------------------------------------------------
def _read_png(data):
    """Decode an unfiltered 8-bit PNG with zlib alone."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n = int.from_bytes(data[pos:pos + 4], "big")
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        crc = int.from_bytes(data[pos + 8 + n:pos + 12 + n], "big")
        assert zlib.crc32(kind + body) & 0xFFFFFFFF == crc, kind
        chunks[kind] = chunks.get(kind, b"") + body
        pos += 12 + n
    w = int.from_bytes(chunks[b"IHDR"][0:4], "big")
    h = int.from_bytes(chunks[b"IHDR"][4:8], "big")
    c = {0: 1, 2: 3, 6: 4}[chunks[b"IHDR"][9]]
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8) \
        .reshape(h, 1 + w * c)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, c), b"IEND" in chunks


@pytest.mark.parametrize("shape", [(5, 7, 3), (4, 9), (3, 2, 4)])
def test_png_writer_roundtrip(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape).astype(np.uint8)
    path = tmp_path / "x.png"
    write_png(str(path), img)
    got, ended = _read_png(path.read_bytes())
    assert ended
    np.testing.assert_array_equal(got.reshape(img.shape), img)
    with pytest.raises(TypeError):
        png_bytes(img.astype(np.float32))
