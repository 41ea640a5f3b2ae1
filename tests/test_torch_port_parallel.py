"""The multi-device path of nnc_tpu_torch against nnc_tpu (CPU, float32).

The port's mesh is one process over ``torch.device`` s that may repeat: here
8 x ``cpu``, where the JAX package runs on its 8 virtual CPU devices
(tests/conftest.py) with its Pallas kernels in interpret mode. Inputs are
made with numpy from a seed and given to both packages. Tolerances:
  (a) ``shard_tp_weights``: every shard equals the reference's, with the TPU
      kernel's padding stripped, exactly (the same float32 products);
  (b) ``fused_pair_plain`` against the Pallas pair kernel: rtol 1e-5, atol
      1e-5 (two float32 products whose sums run in another order);
  (c) ``fused_nerf_mlp_tp`` against the reference's and against the dense
      MLP: rtol 1e-4, atol 1e-5 (tests/test_parallel.py:296);
  (d) a data-parallel LSA step on a mesh against one device on the same
      draws: loss rel 1e-5, scales rtol 1e-4 / atol 1e-6
      (tests/test_parallel.py:63-67); against the JAX step with its draws
      replayed: loss rel 1e-4, scales rtol 2e-4 / atol 2e-6
      (tests/test_torch_port_train.py's bar);
  (e) ``render_image(mesh=)`` against the render without a mesh, empty-ray
      culling and early termination off: rtol 1e-5, atol 1e-6 (the CPU's
      matrix products may round differently for another batch size). With
      both on, rays are grouped into tiles within each shard, so a culled
      ray may get its coarse colour in one render and its fine colour in
      the other: atol 5e-3, the reference's bound for a culled render
      against the exact one (tests/test_mlp_pallas.py);
  (f) joint multi-scene LSA against each scene tuned alone: scales rtol
      2e-4 / atol 2e-6, PSNR within 0.05 dB (tests/test_multi_scene.py).
"""
import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

import nnc_tpu_torch
from nnc_tpu import parallel as jparallel
from nnc_tpu.data import synthetic as jsynthetic
from nnc_tpu.models import nerf as jnerf
from nnc_tpu.ops import mlp_tp_pallas
from nnc_tpu.render import renderer as jrenderer
from nnc_tpu.train import lsa as jlsa
from nnc_tpu_torch import graft_entry
from nnc_tpu_torch import parallel as tparallel
from nnc_tpu_torch.data import synthetic as tsynthetic
from nnc_tpu_torch.data.rays import RayBatcher
from nnc_tpu_torch.models import nerf as tnerf
from nnc_tpu_torch.ops import _build, mlp_fused, mlp_tp_fused
from nnc_tpu_torch.parallel import multi_scene
from nnc_tpu_torch.render import renderer as trenderer
from nnc_tpu_torch.train import lsa as tlsa

CPU8 = dict(devices=["cpu"])


def _np_tree(p):
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def flagship():
    """Full-width weights with LSA scales (std 0.1) as numpy, the JAX
    pytrees of them and the port's model."""
    cfg = jnerf.NeRFConfig()
    params = _np_tree(jnerf.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(5)
    ls = {name: (1.0 + 0.1 * rng.standard_normal(p["b"].shape[0]))
          .astype(np.float32) for name, p in params.items()}
    model = tnerf.from_jax_params(params, tnerf.NeRFConfig(), ls=ls)
    return (cfg, jax.tree.map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in ls.items()}, model)


# meshes ---------------------------------------------------------------------
@pytest.mark.parametrize("axes", [("data",), ("data", "model")])
def test_make_mesh_shapes_match_reference(axes):
    want = jparallel.make_mesh(8, axes)
    got = tparallel.make_mesh(8, axes, **CPU8)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert all(d == torch.device("cpu") for d in got.devices.flat)


def test_make_mesh_explicit_shape_and_errors():
    mesh = tparallel.make_mesh(8, ("data", "model"), shape=(2, 4), **CPU8)
    assert mesh.shape == {"data": 2, "model": 4}
    assert len(mesh.axis_devices("model")) == 4
    assert len(tparallel.data_devices(mesh)) == 2
    with pytest.raises(ValueError, match="explicit shape"):
        tparallel.make_mesh(8, ("a", "b", "c"), **CPU8)
    with pytest.raises(ValueError, match="does not hold"):
        tparallel.make_mesh(8, ("data",), shape=(3,), **CPU8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tparallel.make_mesh(4)


def test_shard_inputs_layout():
    mesh = tparallel.make_mesh(8, ("data",), **CPU8)
    a = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    (parts,) = tparallel.shard_train_inputs(mesh, a)
    assert len(parts) == 8 and all(p.shape == (2, 3) for p in parts)
    np.testing.assert_array_equal(torch.cat(parts).numpy(), a)
    with pytest.raises(ValueError, match="does not divide"):
        tparallel.shard_train_inputs(mesh, a[:15])
    packed = np.arange(3 * 16 * 12, dtype=np.float32).reshape(3, 16, 12)
    parts = tparallel.shard_scan_inputs(mesh, packed)
    assert len(parts) == 8 and all(p.shape == (3, 2, 12) for p in parts)
    np.testing.assert_array_equal(torch.cat(parts, dim=1).numpy(), packed)
    # a mesh with a 'model' axis splits over 'data' only
    mesh2 = tparallel.make_mesh(8, ("data", "model"), shape=(2, 4), **CPU8)
    (parts,) = tparallel.shard_train_inputs(mesh2, a)
    assert [tuple(p.shape) for p in parts] == [(8, 3), (8, 3)]


def test_replicate_and_tp_placement():
    mesh = tparallel.make_mesh(8, ("data", "model"), shape=(2, 4), **CPU8)
    model = tnerf.init_params(tnerf.NeRFConfig(W=16),
                              torch.Generator().manual_seed(0))
    reps = tparallel.replicate_params(mesh, model)
    assert list(reps) == [torch.device("cpu")]
    assert reps[torch.device("cpu")] is model   # one replica, the model
    placed = tparallel.shard_params_tp(mesh, model)
    assert len(placed) == 4
    for name, layer in model.layers().items():
        w = layer.weight.detach().t()
        if w.shape[1] % 4 == 0:
            got = torch.cat([p[name + ".weight"] for p in placed], dim=1)
            bias = torch.cat([p[name + ".bias"] for p in placed])
        else:   # alpha (1) and rgb (3) outputs stay whole
            got, bias = placed[0][name + ".weight"], placed[0][name + ".bias"]
        assert torch.equal(got, w) and torch.equal(bias, layer.bias.detach())
    total = tparallel.psum([torch.full((2,), float(i)) for i in range(4)],
                           mesh.axis_devices("model"))
    assert list(total) == [torch.device("cpu")]
    assert total[torch.device("cpu")].tolist() == [6.0, 6.0]


# (a) ------------------------------------------------------------------------
@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_shard_tp_weights_match_reference(flagship, m):
    _cfg, jparams, jls, model = flagship
    want_sh, want_rep = mlp_tp_pallas.shard_tp_weights(jparams, jls, m)
    shards, reps = mlp_tp_fused.shard_tp_weights(model, m)
    assert set(shards) == set(want_sh) and set(reps) == set(want_rep)
    for key, got in shards.items():
        want = np.asarray(want_sh[key])
        if key == "w0":
            assert not want[:, 63:].any()     # the packed input's padding
            want = want[:, :63]
        elif key.startswith("b"):
            want = want[:, 0]                  # (M, 1, S) -> (M, S)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=key)
    strip = {"w5a": lambda w: w[:63], "wvb": lambda w: w[64:91],
             "wa": lambda w: w[:, 3:4], "wr": lambda w: w[:, :3],
             "ba": lambda b: b[0, 3:4], "br": lambda b: b[0, :3]}
    for key, got in reps.items():
        want = np.asarray(want_rep[key])
        want = strip[key](want) if key in strip else want[0]
        np.testing.assert_array_equal(got.numpy(), want, err_msg=key)
    with pytest.raises(ValueError, match="do not divide"):
        mlp_tp_fused.shard_tp_weights(model, 3)


# (b) ------------------------------------------------------------------------
@pytest.mark.parametrize("k,s,o2,relu_mid", [(63, 64, 256, True),
                                             (256, 64, 256, True),
                                             (256, 64, 128, False)])
def test_fused_pair_plain_matches_pallas(k, s, o2, relu_mid):
    """The forward's pair shapes at M = 4, N = 2,048."""
    rng = np.random.default_rng(k + o2)
    x = rng.standard_normal((2048, k)).astype(np.float32)
    wa = (rng.standard_normal((k, s)) / np.sqrt(k)).astype(np.float32)
    ba = rng.standard_normal(s).astype(np.float32)
    wb = (rng.standard_normal((s, o2)) / np.sqrt(s)).astype(np.float32)
    want = np.asarray(mlp_tp_pallas.fused_pair(
        jnp.asarray(x), jnp.asarray(wa), jnp.asarray(ba)[None],
        jnp.asarray(wb), relu_mid=relu_mid, interpret=True))
    t = torch.from_numpy
    before = _build.launch_counts()["mlp_tp_pair"]
    got = mlp_tp_fused.fused_pair(t(x), t(wa), t(ba), t(wb), relu_mid)
    assert _build.launch_counts()["mlp_tp_pair"] == before  # CPU: plain
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got, mlp_tp_fused.fused_pair_plain(
        t(x), t(wa), t(ba), t(wb), relu_mid))


def test_fused_pair_refuses_other_devices_and_layouts():
    x, wa, ba, wb = (torch.empty(s, device="meta") for s in
                     ((8, 63), (63, 64), (64,), (64, 256)))
    with pytest.raises(ValueError, match="device"):
        mlp_tp_fused.fused_pair(x, wa, ba, wb)
    with pytest.raises(ValueError, match="contiguous"):
        mlp_tp_fused.fused_pair(torch.zeros(63, 8).t(), torch.zeros(63, 64),
                                torch.zeros(64), torch.zeros(64, 256))
    with pytest.raises(ValueError, match="one device"):
        mlp_tp_fused.fused_pair(torch.zeros(8, 63), wa, ba, wb)


# (c) ------------------------------------------------------------------------
@pytest.mark.parametrize("axes,shape,n", [(("model",), (4,), 2048),
                                          (("data", "model"), (2, 4), 2048),
                                          (("model",), (4,), 777)])
def test_fused_nerf_mlp_tp_matches_reference_and_dense(flagship, axes, shape,
                                                       n):
    cfg, jparams, jls, model = flagship
    rng = np.random.default_rng(n)
    pe = rng.standard_normal((n, 63)).astype(np.float32)
    ve = rng.standard_normal((n, 27)).astype(np.float32)
    jmesh = jparallel.make_mesh(int(np.prod(shape)), axes, shape=shape)
    want = np.asarray(mlp_tp_pallas.fused_nerf_mlp_tp(
        jparams, jls, jnp.asarray(pe), jnp.asarray(ve), cfg, jmesh))
    mesh = tparallel.make_mesh(int(np.prod(shape)), axes, shape=shape, **CPU8)
    with torch.no_grad():
        got = mlp_tp_fused.fused_nerf_mlp_tp(
            model, torch.from_numpy(pe), torch.from_numpy(ve), mesh)
        dense = tnerf.apply_mlp(model, torch.from_numpy(pe),
                                torch.from_numpy(ve))
    assert got.shape == (n, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_fused_nerf_mlp_tp_shapes_and_refusals(flagship):
    *_, model = flagship
    mesh = tparallel.make_mesh(2, ("model",), **CPU8)
    g = torch.Generator().manual_seed(1)
    pe, ve = torch.randn(3, 5, 63, generator=g), torch.randn(3, 5, 27,
                                                             generator=g)
    with torch.no_grad():
        got = mlp_tp_fused.fused_nerf_mlp_tp(model, pe, ve, mesh)
        want = tnerf.apply_mlp(model, pe, ve)
    assert got.shape == (3, 5, 4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError, match="flagship"):
        mlp_tp_fused.fused_nerf_mlp_tp(
            tnerf.NeRF(tnerf.NeRFConfig(W=64)), pe, ve, mesh)
    with pytest.raises(ValueError, match="'model' axis"):
        mlp_tp_fused.fused_nerf_mlp_tp(
            model, pe, ve, tparallel.make_mesh(2, ("data",), **CPU8))


# the packed-weights cache -----------------------------------------------------
def test_pack_cache_hits_misses_and_equal_outputs(flagship):
    """One cache serves the four model-level wrappers: a second call hits, an
    in-place change of a weight, a bias or a scale (an optimizer step,
    load_state_dict) misses, and the outputs equal a fresh packing's."""
    *_, src = flagship
    model = tnerf.NeRF(src.config)
    model.load_state_dict(src.state_dict(), strict=False)
    for dst, s in zip(model.layers().values(), src.layers().values()):
        dst.weight_scaling = s.weight_scaling.clone()
    cache = mlp_fused.PACKS
    g = torch.Generator().manual_seed(2)
    pts, vd = torch.randn(40, 3, generator=g), torch.randn(40, 3, generator=g)
    pe, ve = torch.randn(40, 63, generator=g), torch.randn(40, 27,
                                                           generator=g)
    mesh = tparallel.make_mesh(4, ("model",), **CPU8)
    calls = {
        "points": lambda: mlp_fused.fused_nerf_mlp_from_points(model, pts, vd),
        "int8": lambda: mlp_fused.fused_nerf_mlp_int8_from_points(model, pts,
                                                                  vd),
        "embedded": lambda: mlp_fused.fused_nerf_mlp(model, pe, ve),
        "tp": lambda: mlp_tp_fused.fused_nerf_mlp_tp(model, pe, ve, mesh),
    }

    def run_all():
        with torch.no_grad():
            return {k: fn() for k, fn in calls.items()}

    h0, m0 = cache.hits, cache.misses
    first = run_all()
    # points and embedded share the float32 buffer: 3 packings, 1 hit
    assert (cache.hits - h0, cache.misses - m0) == (1, 3)
    again = run_all()
    assert (cache.hits - h0, cache.misses - m0) == (5, 3)
    for k in first:
        assert torch.equal(first[k], again[k]), k
    fresh = mlp_fused.mlp_from_points(mlp_fused.pack_weights(model), pts, vd)
    assert torch.equal(first["points"], fresh)

    def changes():
        layer = model.pts_linears[3]
        with torch.no_grad():
            layer.weight_scaling.mul_(1.5)                 # an LSA step
        yield "scale"
        with torch.no_grad():
            layer.bias.add_(0.25)
        yield "bias"
        sd = {k: v + 0.01 for k, v in model.state_dict().items()}
        model.load_state_dict(sd)
        yield "load_state_dict"
        layer.weight_scaling = layer.weight_scaling * 0.5  # a new tensor
        yield "replaced scale"

    for what in changes():
        h, m = cache.hits, cache.misses
        out = run_all()
        assert (cache.hits - h, cache.misses - m) == (1, 3), what
        for k in first:
            assert not torch.equal(out[k], first[k]), (what, k)
        fresh = mlp_fused.mlp_from_points(mlp_fused.pack_weights(model), pts,
                                          vd)
        assert torch.equal(out["points"], fresh), what
        np.testing.assert_allclose(
            out["tp"].numpy(), tnerf.apply_mlp(model, pe, ve).detach().numpy(),
            rtol=1e-4, atol=1e-5, err_msg=what)
        first = out
    # another model has its own entries
    h, m = cache.hits, cache.misses
    with torch.no_grad():
        mlp_fused.fused_nerf_mlp(src, pe, ve)
    assert cache.misses == m + 1 and cache.hits == h


# (d) ------------------------------------------------------------------------
MLP_J, MLP_T = jnerf.NeRFConfig(W=16), tnerf.NeRFConfig(W=16)
RC_KW = dict(n_samples=8, n_importance=4, chunk=16)


def _jax_draws(key, R, rc):
    """The draws the JAX render_rays takes from ``key``, as torch tensors
    (tests/test_torch_port_train.py)."""
    k_strat, k_pdf, k_n0, k_n1 = jax.random.split(key, 4)
    t = lambda a: torch.from_numpy(np.array(a))
    return {"t_rand": t(jax.random.uniform(k_strat, (R, rc.n_samples))),
            "u": t(jax.random.uniform(k_pdf, (R, rc.n_importance))),
            "noise0": t(jax.random.normal(k_n0, (R, rc.n_samples))),
            "noise1": t(jax.random.normal(
                k_n1, (R, rc.n_samples + rc.n_importance)))}


class _Batches:
    def __init__(self, batches):
        self.batches = list(batches)

    def next_batch(self):
        return self.batches.pop(0)


def _lsa_case():
    """tests/test_parallel.py:31-67's case: W=16, 8 + 4 samples, 16 rays;
    the weights given visible density, so that the gradients are not zero
    and the scales move."""
    key = jax.random.PRNGKey(0)
    params = tuple(_np_tree(jsynthetic._activate(jnerf.init_params(k, MLP_J),
                                                 seed))
                   for seed, k in enumerate((key, jax.random.fold_in(key, 1))))
    rng = np.random.default_rng(0)
    ro = rng.normal(0, 1, (16, 3)).astype(np.float32)
    rd = (rng.normal(0, 1, (16, 3)) - [0, 0, 2]).astype(np.float32)
    tgt = rng.uniform(0, 1, (16, 3)).astype(np.float32)
    return params, (ro, rd, tgt)


def _torch_models(params):
    return tuple(tnerf.init_lsa_scales(tnerf.from_jax_params(p, MLP_T))
                 for p in params)


def test_data_parallel_lsa_step_matches_single_device_and_jax():
    params, batch = _lsa_case()
    rc_j = jrenderer.RenderConfig(mlp=MLP_J, **RC_KW)
    rc_t = trenderer.RenderConfig(mlp=MLP_T, **RC_KW)
    key = jax.random.PRNGKey(7)
    optimizer = optax.adam(1e-3)
    scales = (jnerf.init_lsa_scales(MLP_J), jnerf.init_lsa_scales(MLP_J))
    step = jlsa.make_train_step(rc_j, optimizer)
    s_j, _, loss_j, _ = step(
        scales, optimizer.init(scales),
        tuple(jax.tree.map(jnp.asarray, p) for p in params),
        jnp.asarray(batch[0]), jnp.asarray(batch[1]), None,
        jnp.asarray(batch[2]), 2.0, 6.0, key)

    draws = _jax_draws(key, 16, rc_t)
    kw = dict(learning_rate=1e-3, learning_rate_decay=0.0, epochs=1,
              n_iters=1, verbose=False, draws=lambda i: draws)
    one = tlsa.tune_lsa_scales(*_torch_models(params), _Batches([batch]),
                               rc_t, 2.0, 6.0, **kw)
    mesh = tparallel.make_mesh(8, ("data",), **CPU8)
    many = tlsa.tune_lsa_scales(*_torch_models(params), _Batches([batch]),
                                rc_t, 2.0, 6.0, mesh=mesh, **kw)
    assert many[3] == pytest.approx(one[3], rel=1e-5)
    assert many[3] == pytest.approx(float(loss_j), rel=1e-4)
    moved = 0.0
    for got, single, want in zip(many[:2], one[:2], s_j):
        for name in want:
            np.testing.assert_allclose(got[name].numpy(),
                                       single[name].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=name)
            np.testing.assert_allclose(got[name].numpy(),
                                       np.asarray(want[name]), rtol=2e-4,
                                       atol=2e-6, err_msg=name)
            moved = max(moved, float((got[name] - 1).abs().max()))
    assert moved > 5e-4


def test_data_parallel_lsa_trajectory_and_seeded_draws():
    """Three steps with raw noise, the draws from the seeded generator: the
    mesh run draws once per batch what the single-device run draws lazily,
    in the same order, so the two agree without replayed draws; and a mesh
    with a 'model' axis splits over its 'data' axis only."""
    params, batch = _lsa_case()
    rc = trenderer.RenderConfig(mlp=MLP_T, raw_noise_std=1.0, **RC_KW)
    kw = dict(learning_rate=1e-3, learning_rate_decay=0.0, epochs=1,
              n_iters=3, seed=11, verbose=False)
    one = tlsa.tune_lsa_scales(*_torch_models(params), _Batches([batch] * 3),
                               rc, 2.0, 6.0, **kw)
    mesh = tparallel.make_mesh(8, ("data", "model"), shape=(4, 2), **CPU8)
    many = tlsa.tune_lsa_scales(*_torch_models(params),
                                _Batches([batch] * 3), rc, 2.0, 6.0,
                                mesh=mesh, **kw)
    assert many[3] == pytest.approx(one[3], rel=1e-5)
    assert many[4] == one[4] == 3
    for got, single in zip(many[:2], one[:2]):
        for name in single:
            np.testing.assert_allclose(got[name].numpy(),
                                       single[name].numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=name)
    with pytest.raises(ValueError, match="do not divide"):
        tlsa.tune_lsa_scales(
            *_torch_models(params), _Batches([tuple(a[:15] for a in batch)]),
            rc, 2.0, 6.0, mesh=mesh, **kw)


def test_compress_model_lsa_on_a_mesh(tmp_path):
    """compress_model(lsa=True, mesh=) tunes data-parallel and writes what
    the run without a mesh writes (the same seed and batches)."""
    rc = trenderer.RenderConfig(mlp=MLP_T, n_samples=8, n_importance=4)
    scene, teachers = tsynthetic.make_scene(n_images=3, H=8, W=8, mlp=MLP_T,
                                            rc=rc, device="cpu")
    sd = tnerf.params_to_state_dict(teachers[0], "model.")
    sd.update(tnerf.params_to_state_dict(teachers[1], "model_fine."))
    mesh = tparallel.make_mesh(4, ("data",), **CPU8)
    sizes = []
    for name, m in (("one", None), ("mesh", mesh)):
        bs = tmp_path / name / "bitstream" / "x.nnc"
        bs.parent.mkdir(parents=True)
        nnc_tpu_torch.compress_model(
            sd, bitstream_path=str(bs), qp=-20, lsa=True, scene=scene,
            mlp_config=MLP_T, n_samples=8, n_importance=4, N_iters=2,
            epochs=1, i_save=0, N_rand=16, learning_rate=1e-2, mesh=m,
            device="cpu" if m is None else None, verbose=False)
        sizes.append(bs.stat().st_size)
        rec = nnc_tpu_torch.decompress(str(bs), verbose=False)
        assert set(rec) == set(sd)
    assert abs(sizes[0] - sizes[1]) <= 0.01 * sizes[0]


# (e) ------------------------------------------------------------------------
def test_render_image_mesh_matches_single(flagship):
    """tests/test_parallel.py:171-193's case: the fused route (here its
    plain versions) at the flagship width, 300 rays in chunks of 256."""
    *_, model = flagship
    rng = np.random.default_rng(0)
    ro = rng.normal(0, 0.1, (300, 3)).astype(np.float32)
    rd = (rng.normal(0, 0.2, (300, 3)) + [0, 0, -1]).astype(np.float32)
    mesh = tparallel.make_mesh(8, **CPU8)
    for eps, tol in ((dict(early_term_eps=0.0, empty_ray_eps=0.0),
                      dict(rtol=1e-5, atol=1e-6)), ({}, dict(atol=5e-3))):
        rc = trenderer.RenderConfig(n_samples=8, n_importance=8, chunk=256,
                                    use_fused_mlp=True,
                                    use_fused_compositing=True, **eps)
        single = trenderer.render_image(model, model, ro, rd, 2.0, 6.0, rc)
        multi = trenderer.render_image(model, model, ro, rd, 2.0, 6.0, rc,
                                       mesh=mesh)
        for k in ("rgb_map", "acc_map"):
            assert multi[k].shape == single[k].shape
            np.testing.assert_allclose(multi[k].numpy(), single[k].numpy(),
                                       err_msg=k, **tol)
    # image-shaped input, a small plain model, a ragged last chunk
    small = tnerf.init_params(MLP_T, torch.Generator().manual_seed(3))
    rc_s = trenderer.RenderConfig(mlp=MLP_T, n_samples=8, n_importance=4,
                                  chunk=16)
    ro_i, rd_i = ro[:40].reshape(5, 8, 3), rd[:40].reshape(5, 8, 3)
    single = trenderer.render_image(small, None, ro_i, rd_i, 2.0, 6.0, rc_s)
    multi = trenderer.render_image(small, None, ro_i, rd_i, 2.0, 6.0, rc_s,
                                   mesh=mesh)
    assert multi["rgb_map"].shape == (5, 8, 3)
    np.testing.assert_allclose(multi["rgb_map"].numpy(),
                               single["rgb_map"].numpy(), rtol=1e-5,
                               atol=1e-6)


# (f) ------------------------------------------------------------------------
RC_MS = trenderer.RenderConfig(mlp=MLP_T, n_samples=8, n_importance=4,
                               chunk=64)


def _ms_case(seed):
    """A scene, its teachers with 5% multiplicative noise on every tensor
    (something for the scales to learn) and a fresh batcher."""
    scene, teachers = tsynthetic.make_scene(n_images=2, H=8, W=8, mlp=MLP_T,
                                            rc=RC_MS, seed=seed, device="cpu")
    g = torch.Generator().manual_seed(100 + seed)
    with torch.no_grad():
        for model in teachers:
            for p in model.parameters():
                p.mul_(1 + 0.05 * torch.randn(p.shape, generator=g))
    batcher = lambda: RayBatcher(scene["images"], scene["poses"], scene["K"],
                                 scene["i_train"], 32, seed=seed)
    return scene, teachers, batcher


def _fresh(teachers):
    out = []
    for t in teachers:
        m = tnerf.NeRF(t.config)
        m.load_state_dict(t.state_dict(), strict=False)
        out.append(tnerf.init_lsa_scales(m))
    return tuple(out)


@pytest.mark.parametrize("use_mesh", [False, True])
def test_multi_scene_joint_matches_sequential(use_mesh):
    n_iters, lr, seed = 4, 1e-2, 7
    cases = [_ms_case(0), _ms_case(1)]
    scenes = [c[0] for c in cases]
    mesh = multi_scene.make_scene_mesh(2, 8, **CPU8) if use_mesh else None
    if use_mesh:
        assert mesh.shape == {"scene": 2, "data": 4}
    tuned, psnrs = multi_scene.tune_multi_scene(
        scenes, [_fresh(c[1]) for c in cases], RC_MS,
        batchers=[c[2]() for c in cases], learning_rate=lr, n_iters=n_iters,
        mesh=mesh, seed=seed, verbose=False)
    assert len(tuned) == len(psnrs) == 2
    seeds = multi_scene.scene_seeds(seed, 2)
    assert seeds == multi_scene.scene_seeds(seed, 2) and seeds[0] != seeds[1]
    for i, (scene, teachers, batcher) in enumerate(cases):
        alone, psnr = multi_scene.tune_multi_scene(
            [scene], [_fresh(teachers)], RC_MS, batchers=[batcher()],
            learning_rate=lr, n_iters=n_iters, seeds=[seeds[i]],
            verbose=False)
        moved = 0.0
        for joint_s, seq_s in zip(tuned[i], alone[0]):
            for name in seq_s:
                np.testing.assert_allclose(
                    joint_s[name].numpy(), seq_s[name].numpy(), rtol=2e-4,
                    atol=2e-6, err_msg=f"scene {i} scale {name}")
                moved = max(moved, float((joint_s[name] - 1).abs().max()))
        assert moved > 1e-2          # the scales trained
        # (a last batch of rays that all miss the object has loss 0 in both)
        assert psnrs[i] == psnr[0] or abs(psnrs[i] - psnr[0]) < 0.05
    with pytest.raises(ValueError, match="scenes on a mesh"):
        multi_scene.tune_multi_scene(
            scenes[:1], [_fresh(cases[0][1])], RC_MS,
            batchers=[cases[0][2]()], n_iters=1,
            mesh=multi_scene.make_scene_mesh(2, 8, **CPU8), verbose=False)


def test_multi_scene_sequential_is_tune_lsa_scales():
    """One scene through tune_multi_scene equals tune_lsa_scales on the same
    batches with the same generator seed (the path held against the JAX
    package by tests/test_torch_port_train.py)."""
    scene, teachers, batcher = _ms_case(2)
    (alone,), _ = multi_scene.tune_multi_scene(
        [scene], [_fresh(teachers)], RC_MS, batchers=[batcher()],
        learning_rate=1e-2, n_iters=3, seeds=[5], verbose=False)
    want = tlsa.tune_lsa_scales(
        *_fresh(teachers), batcher(), RC_MS, scene["near"], scene["far"],
        learning_rate=1e-2, learning_rate_decay=0.0, epochs=1, n_iters=3,
        seed=5, verbose=False)
    for got_s, want_s in zip(alone, want[:2]):
        for name in want_s:
            np.testing.assert_allclose(got_s[name].numpy(),
                                       want_s[name].numpy(), rtol=2e-4,
                                       atol=2e-6, err_msg=name)


# the dry run and the entry ----------------------------------------------------
def test_graft_dryrun_multichip_on_cpu(capsys):
    graft_entry.dryrun_multichip(8, devices=["cpu"])
    out = capsys.readouterr().out
    for part in ("OK on mesh {'data': 4, 'model': 2}",
                 "3 steps over shard_scan_inputs OK", "TP fused MLP OK",
                 "fused mesh render OK", "joint==sequential scales verified"):
        assert part in out, part


def test_graft_dryrun_odd_device_count(capsys):
    graft_entry.dryrun_multichip(3, devices=["cpu"])
    out = capsys.readouterr().out
    assert "OK on mesh {'data': 3}" in out and "TP fused" not in out


def test_graft_entry_runs_and_matches_jax_render():
    """entry() in float32 at a reduced ray count on the CPU: finite (n, 3)
    colours that equal the JAX renderer's on the same weights and rays (atol
    1e-5; the bf16 entry, the default as in the JAX package, is held against
    it in tests/test_torch_port_bf16.py)."""
    fn, args = graft_entry.entry(n_rays=24, device="cpu",
                                 compute_dtype=torch.float32)
    rgb = fn(*args)
    assert rgb.shape == (24, 3) and bool(torch.isfinite(rgb).all())
    model_c, model_f, rays_o, rays_d = args
    cfg = jnerf.NeRFConfig()
    rc = jrenderer.RenderConfig(mlp=cfg, n_samples=64, n_importance=128,
                                white_bkgd=True, chunk=1024)
    jp = lambda m: {n: {"w": jnp.asarray(l.weight.detach().numpy().T),
                        "b": jnp.asarray(l.bias.detach().numpy())}
                    for n, l in m.layers().items()}
    ro, rd = jnp.asarray(rays_o.numpy()), jnp.asarray(rays_d.numpy())
    want = jrenderer.render_rays(
        jp(model_c), jp(model_f), None, None, ro, rd,
        rd / jnp.linalg.norm(rd, axis=-1, keepdims=True), 2.0, 6.0,
        jax.random.PRNGKey(1), rc, deterministic=True)["rgb_map"]
    np.testing.assert_allclose(rgb.numpy(), np.asarray(want), atol=1e-5)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            graft_entry.entry()
        with pytest.raises(RuntimeError, match="CUDA"):
            graft_entry.dryrun_multichip(4)
