"""Kernels K-B3 and K-B2 of nnc_tpu_torch.

On the CPU the wrappers run their plain PyTorch versions; those are held
against the JAX package's Pallas kernels run in interpret mode, at full
width, on inputs made from a numpy seed:
  * K-B3 (mlp_from_points) vs fused_nerf_mlp_from_points, one 2048-point
    tile: rtol 1e-4, atol 1e-5;
  * K-B2 (render_pass) vs fused_render_pass, R=40 (ray padding), S=64 (two
    sample blocks): atol 1e-5 (depth 1e-4, it sums w * z with z up to 6);
    with early termination at eps = 1e-3 both stay within 2 eps of each
    other; dead ray_flags tiles output exact zeros.
The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_port_cuda.py.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nnc_tpu.data.synthetic import _activate
from nnc_tpu.models import nerf as jnerf
from nnc_tpu.ops import mlp_pallas, render_pallas
from nnc_tpu_torch.models import nerf as tnerf
from nnc_tpu_torch.ops import _build, mlp_fused, render_fused


@pytest.fixture(scope="module")
def flagship():
    """Activated full-width weights (visible density), with LSA scales, as
    numpy, and the port's model of them."""
    cfg = jnerf.NeRFConfig()
    params = _activate(jnerf.init_params(jax.random.PRNGKey(0), cfg), 3)
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(8)
    ls = {name: (1.0 + 0.05 * rng.standard_normal(p["b"].shape[0]))
          .astype(np.float32) for name, p in params.items()}
    model = tnerf.from_jax_params(params, tnerf.NeRFConfig(), ls=ls)
    jparams = jax.tree.map(jnp.asarray, params)
    jls = {k: jnp.asarray(v) for k, v in ls.items()}
    return cfg, jparams, jls, model


def _rays(R, S, seed):
    rng = np.random.default_rng(seed)
    ro = (0.1 * rng.standard_normal((R, 3))).astype(np.float32)
    rd = (0.2 * rng.standard_normal((R, 3)) + [0, 0, -1.0]) \
        .astype(np.float32)
    vd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, (R, S)), axis=-1).astype(np.float32)
    return ro, rd, vd, z


def test_supports_only_flagship():
    assert mlp_fused.supports(tnerf.NeRFConfig())
    assert not mlp_fused.supports(tnerf.NeRFConfig(W=32))
    with pytest.raises(ValueError):
        mlp_fused.pack_weights(tnerf.NeRF(tnerf.NeRFConfig(W=32)))


def test_pack_weights_layout(flagship):
    """The packed buffer holds each layer's folded (in, out) weight and bias
    at the offsets the kernels compute (nerf_mlp.cuh layer_offset)."""
    _cfg, jparams, jls, model = flagship
    packed = mlp_fused.pack_weights(model)
    assert packed.shape == (mlp_fused.PARAMS_SIZE,) == (595968,)
    L = mlp_fused.unpack_weights(packed)
    folded = jnerf.fold_lsa(jparams, jls)
    off = 0
    for name, (din, dout) in jnerf._layer_dims(jnerf.NeRFConfig()).items():
        w, b = L[name]
        assert w.data_ptr() == packed.data_ptr() + 4 * off
        np.testing.assert_allclose(w.numpy(), np.asarray(folded[name]["w"]),
                                   rtol=1e-6)
        np.testing.assert_array_equal(b.numpy(), np.asarray(folded[name]["b"]))
        off += -(-(din * dout + dout) // 64) * 64


def test_mlp_from_points_plain_matches_pallas_interpret(flagship):
    cfg, jparams, jls, model = flagship
    rng = np.random.default_rng(1)
    n = mlp_pallas.TILE
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    vd = rng.standard_normal((n, 3)).astype(np.float32)
    want = np.asarray(mlp_pallas.fused_nerf_mlp_from_points(
        jparams, jls, jnp.asarray(pts), jnp.asarray(vd), cfg))
    before = _build.launch_counts()
    got = mlp_fused.fused_nerf_mlp_from_points(model, torch.from_numpy(pts),
                                               torch.from_numpy(vd))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    # CPU tensors take the plain version: no kernel launch is counted
    assert _build.launch_counts() == before


def test_mlp_from_points_non_flagship_uses_plain_mlp():
    cfg = tnerf.NeRFConfig(W=32)
    model = tnerf.init_params(cfg, torch.Generator().manual_seed(0))
    pts = torch.randn(2, 5, 3, generator=torch.Generator().manual_seed(1))
    vd = torch.randn(2, 1, 3, generator=torch.Generator().manual_seed(2))
    out = mlp_fused.fused_nerf_mlp_from_points(model, pts, vd)
    assert out.shape == (2, 5, 4)


@pytest.mark.parametrize("case", ["exact", "flags"])
def test_render_pass_plain_matches_pallas_interpret(flagship, case):
    cfg, jparams, jls, model = flagship
    R, S = (40, 64) if case == "exact" else (64, 32)
    ro, rd, vd, z = _rays(R, S, seed=2)
    flags = None
    if case == "flags":
        flags = np.arange(R) < 32   # second 32-ray tile dead
    j = lambda a: None if a is None else jnp.asarray(a)
    want = render_pallas.fused_render_pass(
        jparams, jls, j(ro), j(rd), j(vd), j(z), cfg, early_term_eps=0.0,
        ray_flags=j(flags), r_t=32)
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = render_fused.fused_render_pass(
        model, t(ro), t(rd), t(vd), t(z), early_term_eps=0.0,
        ray_flags=t(flags), r_t=32)
    for k in ("rgb_map", "acc_map", "weights", "depth_map", "disp_map"):
        atol = {"depth_map": 1e-4, "disp_map": 1e-4}.get(k, 1e-5)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=atol, rtol=1e-5, err_msg=k)
    if case == "flags":
        assert got["rgb_map"][32:].abs().max() == 0.0
        assert got["weights"][32:].abs().max() == 0.0


def test_render_pass_early_termination_within_two_eps(flagship):
    cfg, jparams, jls, _model = flagship
    # a denser fog, so that rays saturate and tiles terminate early
    jparams = dict(jparams, alpha_linear={
        "w": jparams["alpha_linear"]["w"] * 10.0,
        "b": jparams["alpha_linear"]["b"] + 20.0})
    model = tnerf.from_jax_params(jax.tree.map(np.asarray, jparams),
                                  tnerf.NeRFConfig(),
                                  ls={k: np.asarray(v) for k, v in jls.items()})
    eps = 1e-3
    R, S = 40, 64
    ro, rd, vd, z = _rays(R, S, seed=3)
    want = render_pallas.fused_render_pass(
        jparams, jls, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(vd),
        jnp.asarray(z), cfg, early_term_eps=eps)
    t = torch.from_numpy
    got = render_fused.fused_render_pass(model, t(ro), t(rd), t(vd), t(z),
                                         early_term_eps=eps)
    exact = render_fused.fused_render_pass(model, t(ro), t(rd), t(vd), t(z))
    for k in ("rgb_map", "acc_map"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2 * eps, rtol=0, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), exact[k].numpy(),
                                   atol=eps, rtol=0, err_msg=k)
    # depth sums w * z: its bound scales with the far plane
    np.testing.assert_allclose(got["depth_map"].numpy(),
                               np.asarray(want["depth_map"]),
                               atol=2 * eps * 6.0, rtol=0)
    # the pass really terminated: whole trailing blocks were skipped
    assert (got["weights"][:, render_fused.SAMPLE_BLOCK:] == 0).all(1).any()


def test_render_pass_wrapper_checks_inputs():
    R, S = 4, 8
    p = torch.zeros(mlp_fused.PARAMS_SIZE)
    r3 = torch.zeros(R, 3)
    zs = torch.ones(R, S)
    live = torch.ones(R, dtype=torch.int32)
    with pytest.raises(ValueError):
        render_fused.render_pass(p, r3, r3, r3, zs.double(), zs, live, 1.0)
    with pytest.raises(ValueError):
        render_fused.render_pass(p, r3, r3, r3, zs, zs, live.long(), 1.0)
    with pytest.raises(ValueError):
        mlp_fused.mlp_from_points(p[:-1], r3, r3)
    maps, w = render_fused.render_pass(p, r3, r3, r3, zs, zs, live,
                                       math.inf, want_weights=False)
    assert maps.shape == (R, 5) and w is None
