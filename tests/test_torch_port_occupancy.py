"""Occupancy mode of nnc_tpu_torch (render/occupancy.py, the occupancy LSA
loss, the executer's branches) against nnc_tpu on the CPU.

The same inputs, made from a seed with numpy, go to both packages; the JAX
side runs as tests/test_occupancy.py runs it (grids from the plain MLP,
K-B2's Pallas kernel in interpret mode). Bars:
  * the grid (occ, open_boundary, the tight box), ``lookup`` and the
    selection (z, dists, flags): equal, bit for bit;
  * fast renders in float32: rgb / acc within 2e-5, depth within 1e-4 (K-B2's
    plain version against the Pallas kernel: the same compositing, MLP sums
    in another order);
  * bf16: rgb / acc in units of the reference's own bf16-to-float32
    distance on the same network and rays (rms error <= 1/8 of it, max
    error <= 1/2 of it), as every bf16 bar of the port's tests;
  * the occupancy LSA loss: the value to rtol 1e-5, scale gradients to
    rtol 1e-4 with atol 1e-4 of their max (narrow net: the JAX MLP folds
    the scales into W, the port scales the outputs), the flagship's through
    the kernel pair K-B1 by tests/test_torch_port_train.py's criterion;
  * tuned scales: to rtol 2e-4 / atol 2e-6 (tests/test_multi_scene.py's
    bar) on the narrow net; the executer's flagship run by the criterion of
    tests/test_mlp_train_pallas.py:41-50 on the scales' moves from 1 (Adam's
    first steps move an element by ~lr whatever the size of its gradient,
    so a near-zero gradient that rounds to the other sign moves it the
    other way); test PSNR within 0.1 dB (BASELINE.json's tolerance).
Grids are built at res 32 here (128 by default), the executer's at 16.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nnc_tpu.data import synthetic as jsynthetic
from nnc_tpu.framework.executer import NeRFModelExecuter as JExecuter
from nnc_tpu.models import nerf as jnerf
from nnc_tpu.render import occupancy as jocc
from nnc_tpu.render import renderer as jrenderer
from nnc_tpu.render.rays import get_rays_np, ndc_rays as jndc_rays
from nnc_tpu.train import lsa as jlsa
from nnc_tpu_torch import parallel
from nnc_tpu_torch.framework.executer import NeRFModelExecuter as TExecuter
from nnc_tpu_torch.models import nerf as tnerf
from nnc_tpu_torch.render import occupancy as tocc
from nnc_tpu_torch.render import renderer as trenderer
from nnc_tpu_torch.train import lsa as tlsa

HW = 16
MAPS = ("rgb_map", "acc_map", "depth_map", "disp_map")
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


def _solid(dtype="float32", radius=1.0, density=80.0, noise=0.0, seed=0):
    """make_solid_mlp's weights (N(0, noise^2) added to every weight) as
    numpy, the JAX pytree of them and the port's model."""
    jdt, tdt = DTYPES[dtype]
    cfg = jnerf.NeRFConfig(compute_dtype=jdt)
    params = _np_tree(jsynthetic.make_solid_mlp(cfg, radius=radius,
                                                density=density))
    if noise:
        rng = np.random.default_rng(seed)
        params = {n: {"w": (p["w"] + noise * rng.standard_normal(
            p["w"].shape)).astype(np.float32), "b": p["b"]}
            for n, p in params.items()}
    model = tnerf.from_jax_params(params, tnerf.NeRFConfig(compute_dtype=tdt))
    return cfg, jax.tree.map(jnp.asarray, params), model


def _ref_grid(params, cfg, **kw):
    kw = {"res": 32, "use_fused": False, "chunk": 32768, **kw}
    return jocc.build_occupancy_grid(params, None, cfg, **kw)


def _carry(grid):
    """The reference's grid as the port's."""
    return tocc.grid_from_arrays(np.asarray(grid.occ), grid.lo, grid.hi,
                                 grid.occ_lo, grid.occ_hi, grid.open_boundary)


def _frame(pose_seed=0):
    focal = 0.8 * HW
    K = np.array([[focal, 0, HW / 2], [0, focal, HW / 2], [0, 0, 1]],
                 np.float32)
    pose = jsynthetic.look_at_poses(1, seed=pose_seed)[0]
    ro, rd = get_rays_np(HW, HW, K, pose[:3, :4])
    return ro, rd


def _flat_rays():
    ro, rd = _frame()
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    vd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    return ro, rd, vd


def _rcs(cfg_j, cfg_t, **kw):
    kw = {"n_samples": 64, "n_importance": 0, "perturb": False,
          "early_term_eps": 0.0, **kw}
    return (jrenderer.RenderConfig(mlp=cfg_j, **kw),
            trenderer.RenderConfig(mlp=cfg_t, **kw))


def _assert_maps_close(got, want, keys=MAPS):
    for k in keys:
        tol = 1e-4 if k == "depth_map" else 2e-5
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=0, atol=tol, err_msg=k)


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def _assert_within_bf16_distance(got, want_bf16, want_f32, what=""):
    err, dist = got - want_bf16, want_bf16 - want_f32
    assert _rms(dist) > 0, what
    assert _rms(err) <= _rms(dist) / 8, (what, _rms(err), _rms(dist))
    assert np.abs(err).max() <= np.abs(dist).max() / 2, \
        (what, np.abs(err).max(), np.abs(dist).max())


@pytest.fixture(scope="module")
def solid():
    cfg, params, model = _solid()
    return cfg, params, model, _ref_grid(params, cfg)


# the grid ------------------------------------------------------------------
@pytest.mark.parametrize("dilate", [0, 1, 3])
@pytest.mark.parametrize("use_fused", [False, True],
                         ids=["plain", "kb3_route"])
def test_grid_matches_reference(solid, dilate, use_fused):
    """The port's grid through the plain MLP and through K-B3's route (its
    plain version here) equals the reference's, bit for bit."""
    cfg, params, model, _ = solid
    want = _ref_grid(params, cfg, dilate=dilate)
    got = tocc.build_occupancy_grid(model, res=32, dilate=dilate,
                                    use_fused=use_fused, chunk=32768)
    assert got.occ.dtype == torch.bool and got.res == 32
    np.testing.assert_array_equal(got.occ.numpy(), np.asarray(want.occ))
    assert (got.occ_lo, got.occ_hi, got.open_boundary, got.lo, got.hi) == \
        (want.occ_lo, want.occ_hi, want.open_boundary, want.lo, want.hi)
    assert 0.0 < float(got.occ.float().mean()) < 0.5


def test_grid_dilation_is_the_cross_not_a_cube():
    """One voxel dilated once lights its six face neighbours (scipy's
    default structure), not the 26 of a 3^3 max-pool."""
    occ = torch.zeros(5, 5, 5, dtype=torch.bool)
    occ[2, 2, 2] = True
    once = tocc._dilate(occ, 1)
    assert int(once.sum()) == 7 and not bool(once[1, 1, 2])
    edge = torch.zeros(5, 5, 5, dtype=torch.bool)
    edge[0, 0, 0] = True
    assert int(tocc._dilate(edge, 2).sum()) == 10


def test_fog_teacher_grid_and_frame_match_reference():
    """bench.py's fog teacher (``_activate`` of PRNGKey(7) weights, carried
    across): density leaks through the box, both grids open their boundary
    and agree bit for bit, and the frame rendered through it agrees."""
    cfg = jnerf.NeRFConfig()
    params = _np_tree(jsynthetic._activate(
        jnerf.init_params(jax.random.PRNGKey(7), cfg), 7))
    model = tnerf.from_jax_params(params, tnerf.NeRFConfig())
    jparams = jax.tree.map(jnp.asarray, params)
    want = _ref_grid(jparams, cfg)
    got = tocc.build_occupancy_grid(model, res=32, chunk=32768)
    assert want.open_boundary and got.open_boundary
    np.testing.assert_array_equal(got.occ.numpy(), np.asarray(want.occ))
    assert (got.occ_lo, got.occ_hi) == (want.occ_lo, want.occ_hi)
    rc_j, rc_t = _rcs(cfg, model.config, white_bkgd=True)
    ro, rd = _frame()
    kw = dict(n_candidates=64, budget=48, subsample=2, row_chunk=8)
    _assert_maps_close(
        tocc.render_image_fast(model, ro, rd, 2.0, 6.0, rc_t, got, **kw),
        jocc.render_image_fast(jparams, None, ro, rd, 2.0, 6.0, rc_j, want,
                               **kw))


def test_grid_bf16_matches_reference():
    """In bf16 the density sweep runs the bf16 MLP; the grid still equals
    the reference's bf16 grid."""
    cfg, params, model = _solid("bf16", noise=1e-2)
    for use_fused in (False, True):
        got = tocc.build_occupancy_grid(model, res=32, chunk=32768,
                                        use_fused=use_fused)
        want = _ref_grid(params, cfg)
        np.testing.assert_array_equal(got.occ.numpy(), np.asarray(want.occ))
        assert (got.occ_lo, got.occ_hi, got.open_boundary) == \
            (want.occ_lo, want.occ_hi, want.open_boundary)


# lookup ----------------------------------------------------------------------
@pytest.mark.parametrize("open_boundary", [False, True])
@pytest.mark.parametrize("hand_built", [False, True])
def test_lookup_matches_reference(solid, open_boundary, hand_built):
    """In-box and out-of-box points, on a built grid (the reference reads
    its packed bits) and on the dry run's hand-built all-ones 16^3 grid
    (the reference reads the bool grid); the port reads a byte grid."""
    if hand_built:
        want = jocc.OccupancyGrid(occ=jnp.ones((16, 16, 16), bool),
                                  lo=(-2.0,) * 3, hi=(2.0,) * 3)
        assert want.occ_bits is None
    else:
        want = solid[3]
        assert want.occ_bits is not None
    want = dataclasses.replace(want, open_boundary=open_boundary)
    got = _carry(want)
    pts = np.random.default_rng(3).uniform(-3, 3, (4096, 3)) \
        .astype(np.float32)
    pts[:8] = [[0, 0, 0], [1.9, 1.9, 1.9], [5, 5, 5], [-2, -2, -2],
               [2, 2, 2], [-2.0001, 0, 0], [1.99999, 0, 0], [0, 0, -5]]
    hit_j = np.asarray(jocc.lookup(want, jnp.asarray(pts)))
    hit_t = tocc.lookup(got, torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(hit_t, hit_j)
    assert hit_t.any() and not (hit_t.all() and not open_boundary)


# selection -------------------------------------------------------------------
@pytest.mark.parametrize("n_candidates,budget", [(64, 32), (64, 8), (48, 16)],
                         ids=["under_budget", "over_budget", "bench"])
@pytest.mark.parametrize("open_boundary", [False, True])
def test_selection_matches_reference(solid, n_candidates, budget,
                                     open_boundary):
    want_grid = dataclasses.replace(solid[3], open_boundary=open_boundary)
    grid = _carry(want_grid)
    ro, rd, _ = _flat_rays()
    jr, tr = (jnp.asarray(ro), jnp.asarray(rd)), \
        (torch.from_numpy(ro), torch.from_numpy(rd))
    want = jocc.select_occupied_samples(want_grid, *jr, 2.0, 6.0,
                                        n_candidates, budget)
    got = tocc.select_occupied_samples(grid, *tr, 2.0, 6.0, n_candidates,
                                       budget)
    for g, w, name in zip(got, want, ("z", "dists", "any")):
        assert g.dtype == (torch.bool if name == "any" else torch.float32)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert 0 < got[2].float().mean() <= 1
    want = jocc.select_occupied_samples_tiled(
        want_grid, *jr, 2.0, 6.0, n_candidates, budget, (HW, HW), 2)
    got = tocc.select_occupied_samples_tiled(
        grid, *tr, 2.0, 6.0, n_candidates, budget, (HW, HW), 2)
    for g, w, name in zip(got, want, ("z", "dists", "any")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def test_compact_stride_matches_reference():
    occ = np.random.default_rng(0).random((64, 64)) < 0.6
    occ[:8] = False
    occ[8:16] = np.random.default_rng(1).random((8, 64)) < 0.1
    want = jocc._compact_stride(jnp.asarray(occ), 64, 16)
    got = tocc._compact_stride(torch.from_numpy(occ), 64, 16)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# renders ---------------------------------------------------------------------
@pytest.mark.parametrize("layout", [None, (HW, HW)], ids=["per_ray", "tiled"])
def test_render_rays_fast_matches_reference(solid, layout):
    cfg, params, model, want_grid = solid
    rc_j, rc_t = _rcs(cfg, model.config, white_bkgd=layout is None)
    ro, rd, vd = _flat_rays()
    kw = dict(n_candidates=64, budget=40, layout=layout, subsample=2)
    want = jocc.render_rays_fast(params, None, *map(jnp.asarray, (ro, rd, vd)),
                                 2.0, 6.0, want_grid, rc_j, **kw)
    got = tocc.render_rays_fast(model, *map(torch.from_numpy, (ro, rd, vd)),
                                2.0, 6.0, _carry(want_grid), rc_t, **kw)
    _assert_maps_close(got, want)
    assert 0.05 < float(got["acc_map"].mean()) < 0.95


@pytest.mark.parametrize("case", ["frame", "ndc_viewdirs", "mesh_2",
                                  "uint8_rgb_only"])
def test_render_image_fast_matches_reference(solid, case):
    """Frames in row chunks: plain, NDC rays with pre-warp viewdirs on the
    NDC-cube grid, rows sharded over a mesh of 2 x cpu (held against the
    reference's single-device frame: the port's shards select the same
    blocks), and rgb alone as uint8."""
    cfg, params, model, want_grid = solid
    rc_j, rc_t = _rcs(cfg, model.config)
    ro, rd = _frame()
    kw = dict(n_candidates=64, budget=40, subsample=2, row_chunk=8)
    t_kw, near, far = {}, 2.0, 6.0
    if case == "ndc_viewdirs":
        want_grid = _ref_grid(params, cfg, lo=(-1.0,) * 3, hi=(1.0,) * 3)
        K = np.array([[0.8 * HW, 0, HW / 2], [0, 0.8 * HW, HW / 2],
                      [0, 0, 1]], np.float32)
        ro, rd = get_rays_np(HW, HW, K, np.eye(4, dtype=np.float32)[:3, :4])
        kw["viewdirs"] = rd / np.linalg.norm(rd, axis=-1, keepdims=True)
        ro_n, rd_n = jndc_rays(HW, HW, 0.8 * HW, 1.0,
                               jnp.asarray(ro.reshape(-1, 3)),
                               jnp.asarray(rd.reshape(-1, 3)))
        ro = np.asarray(ro_n).reshape(HW, HW, 3)
        rd = np.asarray(rd_n).reshape(HW, HW, 3)
        near, far = 0.0, 1.0
    elif case == "mesh_2":
        t_kw["mesh"] = parallel.make_mesh(2, ("data",), devices=["cpu"])
    elif case == "uint8_rgb_only":
        kw.update(outputs=("rgb_map",), rgb_uint8=True)
    want = jocc.render_image_fast(params, None, ro, rd, near, far, rc_j,
                                  want_grid, **kw)
    got = tocc.render_image_fast(model, ro, rd, near, far, rc_t,
                                 _carry(want_grid), **kw, **t_kw)
    assert set(got) == set(want)
    for k in got:
        assert isinstance(got[k], np.ndarray) and \
            got[k].shape == want[k].shape and got[k].dtype == want[k].dtype
    if case == "uint8_rgb_only":
        assert np.abs(got["rgb_map"].astype(int)
                      - want["rgb_map"].astype(int)).max() <= 1
    else:
        _assert_maps_close(got, want)
        assert 0.01 < float(got["acc_map"].mean()) < 0.99


def test_render_image_fast_rejects_rows_that_do_not_divide(solid):
    _, _, model, want_grid = solid
    ro, rd = _frame()
    rc = trenderer.RenderConfig(mlp=model.config)
    mesh = parallel.make_mesh(3, ("data",), devices=["cpu"])
    with pytest.raises(ValueError, match="not divisible"):
        tocc.render_image_fast(model, ro, rd, 2.0, 6.0, rc,
                               _carry(want_grid), subsample=4, mesh=mesh)


@pytest.mark.parametrize("layout", [None, (HW, HW)], ids=["per_ray", "tiled"])
def test_render_rays_fast_bf16_within_distance(layout):
    """bf16 fast renders (K-B2 bf16's plain version against the Pallas
    kernel's bf16 body) on the same grid and selection as float32."""
    cfg16, params, model16 = _solid("bf16", noise=1e-2, seed=4)
    cfg32 = jnerf.NeRFConfig()
    want_grid = _ref_grid(params, cfg32)
    grid = _carry(want_grid)
    ro, rd, vd = _flat_rays()
    kw = dict(n_candidates=48, budget=16, layout=layout, subsample=2)
    run_j = lambda cfg: jocc.render_rays_fast(
        params, None, *map(jnp.asarray, (ro, rd, vd)), 2.0, 6.0, want_grid,
        _rcs(cfg, model16.config)[0], **kw)
    want16, want32 = run_j(cfg16), run_j(cfg32)
    got = tocc.render_rays_fast(model16, *map(torch.from_numpy, (ro, rd, vd)),
                                2.0, 6.0, grid,
                                _rcs(cfg16, model16.config)[1], **kw)
    for k in ("rgb_map", "acc_map"):
        _assert_within_bf16_distance(got[k].numpy(), np.asarray(want16[k]),
                                     np.asarray(want32[k]), k)


# the occupancy LSA loss ----------------------------------------------------
def _lsa_nets(cfg_kw, seed, dtype="float32"):
    """Two activated nets with LSA scales 1 +- 0.05: the JAX config, the
    JAX (params, ls) pytrees and the port's models of them."""
    jdt, tdt = DTYPES[dtype]
    cfg = jnerf.NeRFConfig(**cfg_kw, compute_dtype=jdt)
    nets, models = [], []
    for i in range(2):
        p = _np_tree(jsynthetic._activate(jnerf.init_params(
            jax.random.PRNGKey(seed + i), jnerf.NeRFConfig(**cfg_kw)),
            seed + i))
        rng = np.random.default_rng(seed + 10 + i)
        ls = {n: (1.0 + 0.05 * rng.standard_normal(q["b"].shape[0]))
              .astype(np.float32) for n, q in p.items()}
        nets.append((jax.tree.map(jnp.asarray, p),
                     {k: jnp.asarray(v) for k, v in ls.items()}))
        models.append(tnerf.from_jax_params(
            p, tnerf.NeRFConfig(**cfg_kw, compute_dtype=tdt), ls=ls))
    return cfg, nets, models


def _batch(R, seed):
    rng = np.random.default_rng(seed)
    ro = (0.1 * rng.standard_normal((R, 3)) + [0, 0, 4.0]).astype(np.float32)
    rd = (0.2 * rng.standard_normal((R, 3)) + [0, 0, -1.0]) \
        .astype(np.float32)
    vd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    tgt = rng.uniform(size=(R, 3)).astype(np.float32)
    return ro, rd, vd, tgt


def _occ_draws(key, R, budget):
    """The raw noise double_mse_loss_occ takes from ``key`` (lsa.py:89,
    volume.py:29): coarse from the first half of the split, fine from the
    second."""
    k_c, k_f = jax.random.split(key)
    t = lambda k: torch.from_numpy(np.array(
        jax.random.normal(k, (R, budget))))
    return {"noise0": t(k_c), "noise1": t(k_f)}


@pytest.mark.parametrize("case", ["narrow_plain", "flagship_kb1"])
def test_double_mse_loss_occ_matches_reference(solid, case):
    cfg_kw = {"W": 32} if case == "narrow_plain" else {}
    fused = case == "flagship_kb1"
    cfg, nets, models = _lsa_nets(cfg_kw, seed=3)
    rc_j, rc_t = _rcs(cfg, models[0].config, raw_noise_std=1.0,
                      white_bkgd=True, use_fused_train=fused)
    want_grid = solid[3]
    R = 16
    ro, rd, vd, tgt = _batch(R, 0)
    key = jax.random.PRNGKey(5)

    def loss_j(scales):
        return jlsa.double_mse_loss_occ(
            scales, (nets[0][0], nets[1][0]), *map(jnp.asarray,
                                                   (ro, rd, vd, tgt)),
            2.0, 6.0, key, rc_j, want_grid, 64, 32)

    (loss_w, img_w), grads_w = jax.value_and_grad(loss_j, has_aux=True)(
        (nets[0][1], nets[1][1]))
    tlsa.trained_tensors(*models)
    loss, img = tlsa.double_mse_loss_occ(
        *models, *map(torch.from_numpy, (ro, rd, vd, tgt)), 2.0, 6.0, rc_t,
        _carry(want_grid), 64, 32, draws=_occ_draws(key, R, 32))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_w), rtol=1e-5)
    np.testing.assert_allclose(img.item(), float(img_w), rtol=1e-5)
    for model, gw in zip(models, grads_w):
        for name, layer in model.layers().items():
            got = layer.weight_scaling.grad.numpy().ravel()
            want = np.asarray(gw[name])
            scale = max(np.abs(want).max(), 1e-12)
            if fused:
                close = np.isclose(got, want, rtol=5e-2, atol=5e-3 * scale)
                assert close.mean() > 0.999, name
                assert np.abs(got - want).max() < 0.05 * scale, name
            else:
                np.testing.assert_allclose(got, want, rtol=1e-4,
                                           atol=1e-4 * scale, err_msg=name)
    assert any(np.abs(np.asarray(g)).max() > 0
               for gw in grads_w for g in gw.values())


def test_double_mse_loss_occ_bf16_within_distance(solid):
    """bf16 through the plain MLP (the reference's folded form): the loss
    and the scale gradients in units of the reference's bf16-to-float32
    distance."""
    results = {}
    for dtype in ("bf16", "float32"):
        cfg, nets, models = _lsa_nets({"W": 32}, 3, dtype)
        rc_j, rc_t = _rcs(cfg, models[0].config, white_bkgd=True)
        ro, rd, vd, tgt = _batch(16, 1)
        loss_j = lambda sc: jlsa.double_mse_loss_occ(
            sc, (nets[0][0], nets[1][0]),
            *map(jnp.asarray, (ro, rd, vd, tgt)), 2.0, 6.0,
            jax.random.PRNGKey(0), rc_j, solid[3], 64, 32)
        (lw, _), gw = jax.value_and_grad(loss_j, has_aux=True)(
            (nets[0][1], nets[1][1]))
        flat_w = np.concatenate([np.asarray(g[n]) for g in gw
                                 for n in sorted(g)] + [[float(lw)]])
        if dtype == "bf16":
            tlsa.trained_tensors(*models)
            loss, _ = tlsa.double_mse_loss_occ(
                *models, *map(torch.from_numpy, (ro, rd, vd, tgt)), 2.0, 6.0,
                rc_t, _carry(solid[3]))
            loss.backward()
            results["port"] = np.concatenate(
                [m.layers()[n].weight_scaling.grad.numpy().ravel()
                 for m in models for n in sorted(m.layers())]
                + [[loss.item()]])
        results[dtype] = flat_w
    _assert_within_bf16_distance(results["port"], results["bf16"],
                                 results["float32"], "grads and loss")


class _Batches:
    """The same ray batches, from a seed, for both packages."""

    def __init__(self, R, seed):
        self.R, self.seed = R, seed

    def next_batch(self):
        self.seed += 1
        return _batch(self.R, self.seed)


def _jax_step_keys(n, seed=451):
    key, keys = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        keys.append(sub)
    return keys


def test_tune_lsa_scales_with_grid_matches_reference(solid):
    """Four Adam steps on the occupancy loss (the lr halves after two), the
    same batches, JAX's noise replayed."""
    cfg, nets, models = _lsa_nets({"W": 32}, seed=8)
    rc_j, rc_t = _rcs(cfg, models[0].config, raw_noise_std=1.0)
    kw = dict(learning_rate=5e-3, learning_rate_decay=0.5, epochs=2,
              n_iters=2, seed=451, verbose=False)
    want = jlsa.tune_lsa_scales(
        nets[0][0], nets[1][0], nets[0][1], nets[1][1], _Batches(16, 0),
        rc_j, 2.0, 6.0, steps_per_call=1, grid=solid[3], occ_candidates=64,
        occ_budget=16, **kw)
    keys = _jax_step_keys(4)
    got = tlsa.tune_lsa_scales(
        *models, _Batches(16, 0), rc_t, 2.0, 6.0, grid=_carry(solid[3]),
        occ_candidates=64, occ_budget=16,
        draws=lambda i: _occ_draws(keys[i], 16, 16), **kw)
    assert got[4] == want[4] == 4
    moved = 0.0
    for g_ls, w_ls in zip(got[:2], want[:2]):
        for name in w_ls:
            w = np.asarray(w_ls[name])
            moved = max(moved, np.abs(w - 1).max())
            np.testing.assert_allclose(g_ls[name].numpy(), w, rtol=2e-4,
                                       atol=2e-6, err_msg=name)
    assert moved > 1e-2
    assert abs(got[2] - want[2]) < 0.05


def test_tune_lsa_scales_with_grid_on_a_mesh_equals_one_device(solid):
    """The occupancy loss data-parallel over a mesh of 2 x cpu: the same
    scales as one device on the same draws, up to the order of the float32
    sums."""
    runs = []
    for mesh in (None, parallel.make_mesh(2, ("data",), devices=["cpu"])):
        cfg, _nets, models = _lsa_nets({"W": 32}, seed=8)
        rc = trenderer.RenderConfig(mlp=models[0].config, raw_noise_std=1.0)
        g = torch.Generator().manual_seed(2)
        noise = [tlsa.occ_step_draws(16, rc, 32, g) for _ in range(3)]
        runs.append(tlsa.tune_lsa_scales(
            *models, _Batches(16, 0), rc, 2.0, 6.0, learning_rate=5e-3,
            epochs=1, n_iters=3, verbose=False, mesh=mesh,
            grid=_carry(solid[3]), draws=lambda i: noise[i]))
    for one, two in zip(runs[0][:2], runs[1][:2]):
        for name in one:
            torch.testing.assert_close(two[name], one[name], rtol=1e-5,
                                       atol=1e-7)
    assert abs(runs[0][3] - runs[1][3]) < 1e-6


# executer ------------------------------------------------------------------
def _small_grids(monkeypatch):
    """Both packages' executers build their grids at res 16, and the
    port's builds are recorded."""
    built = []
    for module in (jocc, tocc):
        orig = module.build_occupancy_grid

        def small(*a, _orig=orig, _mod=module, **kw):
            if _mod is tocc:
                built.append(kw.get("dilate", 3))
            return _orig(*a, **{**kw, "res": 16})

        monkeypatch.setattr(module, "build_occupancy_grid", small)
    return built


def test_executer_occupancy_matches_reference(monkeypatch):
    """An executer with both occupancy flags on the flagship: the test
    views through render_image_fast and two LSA steps on the occupancy
    loss, against the JAX executer on the same scene and batches."""
    built = _small_grids(monkeypatch)
    mlp = jnerf.NeRFConfig()
    kw = dict(n_samples=16, n_importance=8, chunk=64,
              use_occupancy_renders=True, use_occupancy_tuning=True)
    rc_j = jrenderer.RenderConfig(mlp=mlp, **kw)
    rc_t = trenderer.RenderConfig(mlp=tnerf.NeRFConfig(), **kw)
    scene, teachers = jsynthetic.make_scene(n_images=2, H=8, W=8, mlp=mlp,
                                            rc=rc_j, seed=3)
    sd = {}
    sd.update(jnerf.params_to_state_dict(teachers[0], "model."))
    sd.update(jnerf.params_to_state_dict(teachers[1], "model_fine."))
    ex_kw = dict(n_iters=2, epochs=1, n_rand=16, i_save=0, verbose=False,
                 learning_rate=5e-3)
    ex_j = JExecuter(scene, rc_j, **ex_kw)
    ex_t = TExecuter(scene, rc_t, device="cpu", **ex_kw)
    psnr_j, psnr_t = ex_j.test_model(sd), ex_t.test_model(sd)
    assert np.isfinite(psnr_t) and abs(psnr_t - psnr_j) < 0.1
    assert built == [3]
    want, _ = ex_j.tune_model(None, sd, None)
    got, _ = ex_t.tune_model(None, sd, None)
    assert built == [3, 1] and set(got) == set(want)
    moves_t = np.concatenate([got[k].ravel() - 1 for k in sorted(want)])
    moves_j = np.concatenate([want[k] - 1 for k in sorted(want)])
    scale = np.abs(moves_j).max()
    assert scale > 1e-3
    close = np.isclose(moves_t, moves_j, rtol=5e-2, atol=5e-3 * scale)
    assert close.mean() > 0.999, 1 - close.mean()
    assert np.abs(moves_t - moves_j).max() < 0.05 * scale
    # an architecture without the kernels renders and tunes exactly, as in
    # the reference
    narrow = TExecuter(scene, dataclasses.replace(
        rc_t, mlp=tnerf.NeRFConfig(W=32)), device="cpu", **ex_kw)
    assert narrow._occupancy_grid(None, None, "use_occupancy_renders") \
        is None
