"""The bf16 compute path of nnc_tpu_torch on the serving side, against the
JAX package with ``compute_dtype=jnp.bfloat16`` (CPU; the Pallas kernels run
their bf16 bodies in interpret mode).

A bf16 result is not a float32 result with a tolerance: a last-bit difference
in a float32 sum can flip the rounding of one activation (2^-8 of it), so no
fixed atol means anything. The bars are stated against the distance between
the bf16 and the float32 result of the reference ON THE SAME NETWORK AND
POINTS, computed in each test:
  * raw logits (plain MLP, K-B3's plain version): rms error <= 1/8 of the
    bf16-to-float32 rms and max error <= 1/2 of the bf16-to-float32 max;
  * composited maps (K-B2's plain version): rgb / acc within 1/2 of the
    bf16-to-float32 max on the maps (+ 2 eps with early termination on: the
    two packages stop rays in tiles of other sizes), on rays whose far
    sample cannot flip (``raw2outputs``' alpha step at the 1e10 sentinel);
  * whole renders: PSNR within 0.1 dB (BASELINE.json's tolerance).
What is exact is held exactly: the rounding itself, and the packed weights.
"""
import os
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import nnc_tpu_torch
from nnc_tpu.data import synthetic as jsynthetic
from nnc_tpu.framework.executer import NeRFModelExecuter as JExecuter
from nnc_tpu.models import nerf as jnerf
from nnc_tpu.ops import mlp_pallas, render_pallas
from nnc_tpu.render import renderer as jrenderer
from nnc_tpu.train import presets as jpresets
from nnc_tpu_torch import graft_entry
from nnc_tpu_torch.models import nerf as tnerf
from nnc_tpu_torch.ops import _build, mlp_fused, render_fused
from nnc_tpu_torch.render import renderer as trenderer
from nnc_tpu_torch.train import presets as tpresets

BF16_J = jnp.bfloat16
BF16_T = torch.bfloat16


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def _assert_within_bf16_distance(got, want_bf16, want_f32, what=""):
    """got (the port, bf16) against the reference's bf16 result, in units of
    the reference's own bf16-to-float32 distance."""
    err, dist = got - want_bf16, want_bf16 - want_f32
    assert _rms(dist) > 0, what
    assert _rms(err) <= _rms(dist) / 8, (what, _rms(err), _rms(dist))
    assert np.abs(err).max() <= np.abs(dist).max() / 2, \
        (what, np.abs(err).max(), np.abs(dist).max())


def _net(cfg_kw, seed, with_ls, activate=False):
    """Weights (and LSA scales 1 +- 0.05) from a seed as numpy, the JAX
    pytrees and the port's bf16 model of them."""
    cfg32 = jnerf.NeRFConfig(**cfg_kw)
    params = jnerf.init_params(jax.random.PRNGKey(seed), cfg32)
    if activate:
        params = jsynthetic._activate(params, seed)
    params = jax.tree.map(np.asarray, params)
    ls = None
    if with_ls:
        rng = np.random.default_rng(seed + 100)
        ls = {name: (1.0 + 0.05 * rng.standard_normal(p["b"].shape[0]))
              .astype(np.float32) for name, p in params.items()}
    model = tnerf.from_jax_params(
        params, tnerf.NeRFConfig(**cfg_kw, compute_dtype=BF16_T), ls=ls)
    jparams = jax.tree.map(jnp.asarray, params)
    jls = None if ls is None else {k: jnp.asarray(v) for k, v in ls.items()}
    cfg16 = jnerf.NeRFConfig(**cfg_kw, compute_dtype=BF16_J)
    return cfg32, cfg16, jparams, jls, model


# rounding ---------------------------------------------------------------------
def test_bf16_round_is_round_to_nearest_even_as_jax():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(50_000) * np.exp2(rng.integers(-140, 127, 50_000)
                                               .astype(np.float64)))
    x = x.astype(np.float32)
    special = np.array([
        1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -(1.0 + 2.0 ** -8),   # ties
        1.0 + 2.0 ** -8 + 2.0 ** -20, 1.0 + 2.0 ** -9,
        0.0, -0.0, 1.0, 2.0 ** -126, 2.0 ** -133, 2.0 ** -149,      # denormals
        3.3895313892515355e38, 3.3961775292304e38,                  # bf16 max, a tie above it
        np.finfo(np.float32).max, -np.finfo(np.float32).max], np.float32)
    x = np.concatenate([x, special])
    want = np.asarray(jnp.asarray(x).astype(BF16_J).astype(jnp.float32))
    got = mlp_fused.bf16_round(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    # ties go to the even neighbour, and the result has 8 significant bits
    assert mlp_fused.bf16_round(torch.tensor(
        [1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8])).tolist() == [1.0,
                                                               1.0 + 2.0 ** -6]
    assert int((got.view(np.uint32) & 0xFFFF).max()) == 0
    assert mlp_fused.bf16_round is tnerf.bf16_round


# the plain MLP ------------------------------------------------------------------
@pytest.mark.parametrize("cfg_kw,n,with_ls", [
    (dict(D=3, W=32, skips=(1,)), 400, True),
    (dict(D=3, W=32, skips=(1,)), 400, False),
    (dict(), 300, True),
    (dict(), 300, False),
], ids=["small-ls", "small", "full-ls", "full"])
def test_plain_bf16_mlp_matches_jax_apply_mlp(cfg_kw, n, with_ls):
    cfg32, cfg16, jparams, jls, model = _net(cfg_kw, 1, with_ls)
    rng = np.random.default_rng(2)
    pe = rng.standard_normal((n, 63)).astype(np.float32)
    ve = rng.standard_normal((n, 27)).astype(np.float32)
    want16 = np.asarray(jnerf.apply_mlp(jparams, jnp.asarray(pe),
                                        jnp.asarray(ve), cfg16, ls=jls))
    want32 = np.asarray(jnerf.apply_mlp(jparams, jnp.asarray(pe),
                                        jnp.asarray(ve), cfg32, ls=jls))
    with torch.no_grad():
        got = tnerf.apply_mlp(model, torch.from_numpy(pe),
                              torch.from_numpy(ve))
    assert got.dtype == torch.float32 and got.shape == (n, 4)
    _assert_within_bf16_distance(got.numpy(), want16, want32)


def test_plain_bf16_linear_is_not_a_bf16_matmul():
    """The sum stays float32: rounding it to bf16 (what F.linear on bf16
    tensors does) is a different, coarser function."""
    layer = tnerf.Linear(256, 256)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        layer.weight.copy_(torch.randn(256, 256, generator=g) / 16)
        x = torch.randn(50, 256, generator=g)
        got = layer(x, compute_dtype=BF16_T)
        exact = (x.bfloat16().double() @ layer.weight.bfloat16().double().t())
        coarse = torch.nn.functional.linear(x.bfloat16(),
                                            layer.weight.bfloat16()).float()
    assert float((got.double() - exact).abs().max()) < 1e-5
    assert float((coarse.double() - exact).abs().max()) > 1e-3


def test_config_accepts_float32_and_bfloat16_only():
    assert tnerf.NeRFConfig().compute_dtype == torch.float32
    assert tnerf.NeRFConfig(compute_dtype=BF16_T).compute_dtype == BF16_T
    with pytest.raises(ValueError):
        tnerf.NeRFConfig(compute_dtype=torch.float16)
    # compute_dtype is no property of a checkpoint
    model = tnerf.init_params(tnerf.NeRFConfig(W=32, compute_dtype=BF16_T),
                              torch.Generator().manual_seed(0))
    sd = tnerf.params_to_state_dict(model, "model.")
    assert tnerf.config_from_state_dict(sd) == tnerf.NeRFConfig(W=32)


# the packing --------------------------------------------------------------------
@pytest.fixture(scope="module")
def flagship():
    """Activated full-width weights with LSA scales and the port's bf16
    model of them."""
    return _net({}, 0, True, activate=True)


def test_bf16_buffer_round_trips_and_holds_the_reference_values(flagship):
    _cfg32, _cfg16, jparams, jls, model = flagship
    buf = mlp_fused.pack_weights_bf16(model)
    assert buf.dtype == torch.int32
    assert buf.shape == (mlp_fused.BF16_PARAMS_SIZE,) == (306240,)
    assert mlp_fused.BF16_SLABS * mlp_fused.MMA_SLAB == 303104
    assert torch.equal(buf, mlp_fused.repack_bf16(
        mlp_fused.pack_weights(model)))
    # every weight exactly once in the slabs, every bias and head value once
    # in the tail
    slab = mlp_fused.BF16_SLAB_INDEX
    real = slab[slab < mlp_fused.PARAMS_SIZE]
    assert real.size == np.unique(real).size == 595844 - 2436 - 256 - 384
    tail = mlp_fused.BF16_TAIL_INDEX
    real_t = tail[tail < mlp_fused.PARAMS_SIZE]
    assert real_t.size == np.unique(real_t).size == 2436 + 256 + 384
    assert not np.intersect1d(real, real_t).size
    # read back: bf16(ls * W) bit for bit as the reference packs it, biases
    # float32 untouched
    got = mlp_fused.unpack_weights_bf16(buf)
    packed_j, biases_j = mlp_pallas._pack_weights(jparams, jls, BF16_J)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    w5 = np.concatenate([f32(packed_j["w5a"])[:63], f32(packed_j["w5b"])])
    wv = np.concatenate([f32(packed_j["wva"]), f32(packed_j["wvb"])[64:91]])
    want_w = {"pts_linears.0": f32(packed_j["w0"])[:63],
              **{f"pts_linears.{i}": f32(packed_j[f"w{i}"])
                 for i in (1, 2, 3, 4, 6, 7)},
              "pts_linears.5": w5, "feature_linear": f32(packed_j["wf"]),
              "alpha_linear": f32(packed_j["wa"])[:, 3:4],
              "views_linears.0": wv, "rgb_linear": f32(packed_j["wr"])[:, :3]}
    want_b = {**{f"pts_linears.{i}": biases_j[f"b{i}"][0] for i in range(8)},
              "feature_linear": biases_j["bf"][0],
              "alpha_linear": biases_j["ba"][0, 3:4],
              "views_linears.0": biases_j["bv"][0],
              "rgb_linear": biases_j["br"][0, :3]}
    assert set(got) == set(want_w)
    for name, (w, b) in got.items():
        np.testing.assert_array_equal(w.numpy().view(np.uint32),
                                      want_w[name].view(np.uint32), name)
        np.testing.assert_array_equal(b.numpy(), np.asarray(want_b[name]),
                                      name)
    with pytest.raises(ValueError):
        mlp_fused.unpack_weights_bf16(buf[:-1])
    with pytest.raises(ValueError):
        mlp_fused.unpack_weights_bf16(buf.float())


def _halves(words):
    """(low, high) bf16 halves of int32 words as float64."""
    u = words.astype(np.int64) & 0xFFFFFFFF
    lo = ((u & 0xFFFF) << 16).astype(np.uint32).view(np.float32)
    hi = (u & 0xFFFF0000).astype(np.uint32).view(np.float32)
    return lo.astype(np.float64), hi.astype(np.float64)


def _fragment_product_bf16(buf, slab0, k_padded, nt_n, x):
    """x (16, k_padded) times the rows of a run of k steps, read from the
    buffer with the index arithmetic of mma_run / PipeT (nerf_mlp_bf16.cuh):
    lane 4 g + t of warp w finds word r of n-tile nt at k step ks at
    slab * 8192 + w * 1024 + (ks % per_slab) * 64 NT + (nt // 2) * 128 +
    lane * 4 + 2 (nt % 2) + r, and its low / high half multiplies channel
    16 ks + 2 t + 8 r + {0, 1} (the m16n8k16 B fragment)."""
    words = buf.numpy()
    per_slab = 16 // nt_n
    out = np.zeros((x.shape[0], 64 * nt_n))
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for ks in range(k_padded // 16):
        for warp in range(8):
            base = (slab0 + ks // per_slab) * 8192 + warp * 1024 \
                + (ks % per_slab) * 64 * nt_n + lane * 4
            for nt in range(nt_n):
                cols = warp * 8 * nt_n + nt * 8 + g
                for r in range(2):
                    lo, hi = _halves(words[base + (nt // 2) * 128
                                           + 2 * (nt % 2) + r])
                    ch = 16 * ks + 2 * t + 8 * r
                    np.add.at(out, (slice(None), cols),
                              x[:, ch] * lo + x[:, ch + 1] * hi)
    return out


@pytest.mark.parametrize("name,row0,rows,slab0,k_padded,nt_n", [
    ("pts_linears.0", 0, 63, 0, 64, 4),
    ("pts_linears.1", 0, 256, 1, 256, 4),
    ("pts_linears.4", 0, 256, 13, 256, 4),
    ("pts_linears.5", 0, 63, 17, 64, 4),
    ("pts_linears.5", 63, 256, 18, 256, 4),
    ("pts_linears.7", 0, 256, 26, 256, 4),
    ("feature_linear", 0, 256, 30, 256, 4),
    ("views_linears.0", 0, 256, 34, 256, 2),
    ("views_linears.0", 256, 27, 36, 32, 2),
])
def test_bf16_buffer_feeds_the_fragments(flagship, name, row0, rows, slab0,
                                         k_padded, nt_n):
    """Reading the buffer as the kernel's lanes do gives x @ bf16(W) for
    every kind of run of k steps (nine of the chain's twelve runs), the zero
    padding rows meeting nonzero channels included."""
    model = flagship[-1]
    buf = mlp_fused.pack_weights_bf16(model)
    with torch.no_grad():
        w = mlp_fused.bf16_round(
            model.layers()[name].effective_weight().t())[row0:row0 + rows]
    x = np.random.default_rng(3).standard_normal((16, k_padded))
    got = _fragment_product_bf16(buf, slab0, k_padded, nt_n, x)
    want = x[:, :rows] @ w.numpy().astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_bf16_buffer_biases_and_heads(flagship):
    model = flagship[-1]
    buf = mlp_fused.pack_weights_bf16(model)
    L = mlp_fused.unpack_weights(mlp_fused.pack_weights(model))
    tail = buf[mlp_fused.BF16_SLABS * mlp_fused.MMA_SLAB:].view(torch.float32)
    r = mlp_fused.bf16_round
    for i in range(8):
        assert torch.equal(tail[256 * i:256 * (i + 1)],
                           L[f"pts_linears.{i}"][1])
    assert torch.equal(tail[2048:2304], L["feature_linear"][1])
    assert torch.equal(tail[2304:2432], L["views_linears.0"][1])
    assert torch.equal(tail[2432:2688], r(L["alpha_linear"][0][:, 0]))
    assert torch.equal(tail[2688:2689], L["alpha_linear"][1])
    assert torch.equal(tail[2692:3076].view(128, 3), r(L["rgb_linear"][0]))
    assert torch.equal(tail[3076:3079], L["rgb_linear"][1])
    assert float(tail[3079:].abs().max()) == 0.0


def test_bf16_wrappers_take_the_plain_version_on_the_cpu(flagship):
    model = flagship[-1]
    g = torch.Generator().manual_seed(1)
    pts, vd = torch.randn(70, 3, generator=g), torch.randn(70, 3, generator=g)
    before = _build.launch_counts()
    misses = mlp_fused.PACKS.misses
    got = mlp_fused.fused_nerf_mlp_from_points(model, pts, vd)
    again = mlp_fused.fused_nerf_mlp_from_points(model, pts, vd)
    assert mlp_fused.PACKS.misses <= misses + 2   # float32, then bf16_mma
    buf = mlp_fused.packed_bf16_for(model)
    assert buf is mlp_fused.packed_bf16_for(model)
    want = mlp_fused.fused_nerf_mlp_from_points_bf16_plain(buf, pts, vd)
    assert torch.equal(got, want) and torch.equal(again, want)
    assert torch.equal(mlp_fused.mlp_from_points_bf16(buf, pts, vd), want)
    assert _build.launch_counts() == before
    assert {"mlp_from_points_bf16", "render_pass_bf16"} <= set(before)
    # the float32 model of the same weights gives another result
    with torch.no_grad():
        f32 = mlp_fused.fused_nerf_mlp_from_points_plain(
            mlp_fused.pack_weights(model), pts, vd)
    assert float((got - f32).abs().max()) > 1e-5
    for bad in (buf[:-64], buf.float(), buf[None]):
        with pytest.raises(ValueError):
            mlp_fused.mlp_from_points_bf16(bad, pts, vd)
    with pytest.raises(ValueError):
        mlp_fused.mlp_from_points_bf16(buf, pts.double(), vd)


# K-B3's plain version against the Pallas bf16 kernel ------------------------------
def test_from_points_bf16_plain_matches_pallas_interpret(flagship):
    cfg32, cfg16, jparams, jls, model = flagship
    rng = np.random.default_rng(1)
    n = 777   # ragged: the reference pads to its 2,048-point tile
    pts = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    vd = rng.standard_normal((n, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    call = lambda cfg: np.asarray(mlp_pallas.fused_nerf_mlp_from_points(
        jparams, jls, jnp.asarray(pts), jnp.asarray(vd), cfg))
    want16, want32 = call(cfg16), call(cfg32)
    got = mlp_fused.fused_nerf_mlp_from_points(
        model, torch.from_numpy(pts), torch.from_numpy(vd)).numpy()
    _assert_within_bf16_distance(got, want16, want32)


# K-B2's plain version against the Pallas bf16 kernel ------------------------------
def _rays(R, S, seed):
    rng = np.random.default_rng(seed)
    ro = (0.1 * rng.standard_normal((R, 3))).astype(np.float32)
    rd = (0.2 * rng.standard_normal((R, 3)) + [0, 0, -1.0]) \
        .astype(np.float32)
    vd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    z = np.sort(rng.uniform(2, 6, (R, S)), axis=-1).astype(np.float32)
    return ro, rd, vd, z


@pytest.mark.parametrize("S,eps,flags", [(32, 0.0, False), (64, 0.0, True),
                                         (64, 1e-4, False), (32, 1e-4, True)])
def test_render_pass_bf16_plain_matches_pallas_interpret(flagship, S, eps,
                                                         flags):
    cfg32, cfg16, jparams, jls, model = flagship
    R = 64
    ro, rd, vd, z = _rays(R, S, seed=2)
    ray_flags = (np.arange(R) < 32) if flags else None   # second tile dead
    j = lambda a: None if a is None else jnp.asarray(a)
    call = lambda cfg: render_pallas.fused_render_pass(
        jparams, jls, j(ro), j(rd), j(vd), j(z), cfg, early_term_eps=eps,
        ray_flags=j(ray_flags), r_t=32)
    want16, want32 = call(cfg16), call(cfg32)
    t = lambda a: None if a is None else torch.from_numpy(a)
    got = render_fused.fused_render_pass(
        model, t(ro), t(rd), t(vd), t(z), early_term_eps=eps,
        ray_flags=t(ray_flags), r_t=32)
    # rays whose far sample (dist 1e10: alpha 0 or 1 by the sign of sigma)
    # lies within the bf16-to-float32 distance of zero may flip
    far = ro + rd * z[:, -1:]
    far16, far32 = (np.asarray(mlp_pallas.fused_nerf_mlp_from_points(
        jparams, jls, j(far), j(vd), cfg))[:, 3] for cfg in (cfg16, cfg32))
    steady = np.abs(far32) > 4 * np.abs(far16 - far32).max()
    live = steady if ray_flags is None else steady & ray_flags
    assert live.sum() >= 16
    for k in ("rgb_map", "acc_map"):
        a, w16, w32 = (np.asarray(m[k] if not torch.is_tensor(m[k])
                                  else m[k].numpy())[live]
                       for m in (got, want16, want32))
        dist = np.abs(w16 - w32).max()
        assert dist > 0
        assert np.abs(a - w16).max() <= dist / 2 + 2 * eps, \
            (k, np.abs(a - w16).max(), dist)
    if flags:
        assert float(got["rgb_map"][32:].abs().max()) == 0.0
        assert float(got["weights"][32:].abs().max()) == 0.0
    assert got["weights"].shape == (R, S)


def test_render_pass_bf16_plain_stops_each_ray_in_its_own_slot(flagship):
    """The bf16 kernel's MLP tile is 4 slots x 32 samples, but each slot
    carries one ray's block: a ray stops alone (RAY_TILE_BF16 = 1, no longer
    with the other three rays of a tile of four), and its plain version
    skips the same blocks."""
    model = flagship[-1]
    assert render_fused.RAY_TILE_BF16 == 1 and render_fused.RAY_TILE == 2
    assert render_fused.SLOTS_BF16 * render_fused.SAMPLE_BLOCK == 128
    R, S = 8, 64
    ro, rd, vd, z = (torch.from_numpy(a) for a in _rays(R, S, seed=5))
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full((R, 1), 1e10)], -1)
    live = torch.ones(R, dtype=torch.int32)
    buf = mlp_fused.packed_bf16_for(model)
    # an opaque first block for rays 0..2 and 4..7: they stop after it,
    # ray 3 goes on (in a tile of four, rays 0..2 went on with it)
    dense = dists.clone()
    dense[[0, 1, 2, 4, 5, 6, 7], :32] = 1e4
    maps, w = render_fused.render_pass_bf16(buf, ro, rd, vd, z, dense, live,
                                            term_csd=5.0)
    stopped = [0, 1, 2, 4, 5, 6, 7]
    assert bool((w[stopped, 32:] == 0).all()) and bool((w[3, 32:] != 0).any())
    exact, w_exact = render_fused.render_pass_bf16(buf, ro, rd, vd, z, dense,
                                                   live, term_csd=np.inf)
    assert float((maps[:, :4] - exact[:, :4]).abs().max()) <= np.exp(-5.0)
    # any culling granularity is a multiple of one ray
    with torch.no_grad():
        a, b = (render_fused.fused_render_pass(model, ro, rd, vd, z, r_t=r_t)
                for r_t in (6, 64))
    assert all(torch.equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError):
        render_fused.render_pass_bf16(mlp_fused.pack_weights(model), ro, rd,
                                      vd, z, dists, live, 1.0)


def test_render_pass_bf16_plain_stops_each_ray_alone(flagship):
    """The bf16 plain version at ray_tile=1 (what the kernel stops by)
    against the reference's exact bf16 render, at the eps bars of
    tests/test_torch_port_fused.py: within eps of the port's own exact render
    (depth 6 eps), within 2 eps plus half the bf16-to-float32 distance of the
    reference's; and, on a batch where no tile of four rays mixes live and
    terminated rays, bit for bit the result of tiles of four."""
    cfg32, cfg16, jparams, jls, model = flagship
    R, S, eps = 64, 64, 1e-3
    ro, rd, vd, z = _rays(R, S, seed=7)
    j, t = jnp.asarray, torch.from_numpy
    want16, want32 = (render_pallas.fused_render_pass(
        jparams, jls, j(ro), j(rd), j(vd), j(z), cfg, early_term_eps=0.0)
        for cfg in (cfg16, cfg32))
    with torch.no_grad():
        got, exact = (render_fused.fused_render_pass(
            model, t(ro), t(rd), t(vd), t(z), early_term_eps=e)
            for e in (eps, 0.0))
    far = ro + rd * z[:, -1:]
    far16, far32 = (np.asarray(mlp_pallas.fused_nerf_mlp_from_points(
        jparams, jls, j(far), j(vd), cfg))[:, 3] for cfg in (cfg16, cfg32))
    steady = np.abs(far32) > 4 * np.abs(far16 - far32).max()
    assert steady.sum() >= 16
    for k, tol in (("rgb_map", eps), ("acc_map", eps),
                   ("depth_map", 6.0 * eps)):
        a = got[k].numpy()
        assert np.abs(a - exact[k].numpy()).max() <= tol, k
        w16, w32 = (np.asarray(w[k]) for w in (want16, want32))
        dist = np.abs(w16 - w32)[steady].max()
        assert np.abs(a - w16)[steady].max() <= dist / 2 + 2 * tol, k
    # tiles of four that stop together: rays 0..3 and 8..11 opaque in their
    # first block, the others never terminate early
    dists = torch.cat([t(z)[:, 1:] - t(z)[:, :-1],
                       torch.full((R, 1), 1e10)], -1)
    dists[list(range(4)) + list(range(8, 12)), :32] = 1e4
    args = (mlp_fused.packed_bf16_for(model), t(ro), t(rd), t(vd), t(z),
            dists, torch.ones(R, dtype=torch.int32), 5.0)
    alone = render_fused.fused_render_pass_bf16_plain(*args)
    fours = render_fused.fused_render_pass_plain(
        *args, mlp_plain=mlp_fused.fused_nerf_mlp_from_points_bf16_plain,
        ray_tile=4)
    assert torch.equal(alone[0], fours[0]) and torch.equal(alone[1], fours[1])
    assert bool((alone[1][:4, 32:] == 0).all())
    assert bool((alone[1][4:8, 32:] != 0).any())


# the slice as a whole ---------------------------------------------------------------
HW, N_SAMPLES, N_IMPORTANCE = 24, 32, 32
MLP_J = jnerf.NeRFConfig(W=32, compute_dtype=BF16_J)
MLP_T = tnerf.NeRFConfig(W=32, compute_dtype=BF16_T)


@pytest.fixture(scope="module")
def small_scene():
    mlp32 = jnerf.NeRFConfig(W=32)
    rc = jrenderer.RenderConfig(mlp=mlp32, n_samples=8, n_importance=4,
                                chunk=HW * HW)
    scene, teachers = jsynthetic.make_scene(n_images=3, H=HW, W=HW,
                                            mlp=mlp32, rc=rc)
    scene["n_importance"] = N_IMPORTANCE
    sd = jnerf.params_to_state_dict(teachers[0], "model.")
    sd.update(jnerf.params_to_state_dict(teachers[1], "model_fine."))
    return scene, sd


def _executers(scene, mlp_j=MLP_J, mlp_t=MLP_T):
    ex_j = JExecuter(scene, jpresets.make_render_config(
        scene, mlp_j, chunk=HW * HW, use_fused_mlp=True,
        n_samples=N_SAMPLES), verbose=False)
    ex_t = tpresets.create_nerf_model_executer(
        scene=scene, device="cpu", mlp_config=mlp_t, use_fused_mlp=True,
        n_samples=N_SAMPLES, verbose=False)
    return ex_j, ex_t


def test_bf16_executer_test_and_eval_model_match_jax(small_scene):
    """bf16 renders of two implementations part wherever one rounding falls
    the other way, by as much as bf16 parts from float32 on that pixel (and
    by a whole fine sample where ``sample_pdf`` jumps): the test views are
    held to half the reference's own bf16-to-float32 distance (rms over the
    image), the PSNRs to 0.1 dB at this size (576 pixels a view; at 256 one
    such pixel moves a 32 dB PSNR by 0.2 dB)."""
    scene, sd = small_scene
    ex_j, ex_t = _executers(scene)
    assert ex_t.rc.mlp.compute_dtype == BF16_T and ex_t.rc.use_fused_mlp
    assert all(m.config.compute_dtype == BF16_T
               for m in ex_t._split_params(sd))
    ex_j32, ex_t32 = _executers(scene, jnerf.NeRFConfig(W=32),
                                tnerf.NeRFConfig(W=32))
    views = scene["i_test"]
    img_t, psnr_t = ex_t._render_views(*ex_t._split_params(sd), views)
    img_j, psnr_j = ex_j._render_views(*ex_j._split_params(sd), views)
    img_j32, psnr_j32 = ex_j32._render_views(*ex_j32._split_params(sd),
                                             views)
    err = np.asarray(img_t) - np.asarray(img_j)
    dist = np.asarray(img_j) - np.asarray(img_j32)
    assert 0 < _rms(err) <= _rms(dist) / 2, (_rms(err), _rms(dist))
    te_j, te_t = ex_j.test_model(sd), ex_t.test_model(sd)
    assert np.isfinite(te_t) and te_t > 15
    # (a second render may differ in a few pixels: the CPU's matrix product
    # sums in an order that depends on where its operands lie in memory, and
    # a last bit decides a bf16 rounding)
    assert abs(te_t - float(np.mean(psnr_t))) < 0.1
    assert abs(te_t - te_j) < 0.1, (te_t, te_j)
    ev_j, ev_t = ex_j.eval_model(sd), ex_t.eval_model(sd)
    assert abs(ev_t[0] - ev_j[0]) < 0.1, (ev_t, ev_j)
    # and bf16 is really what ran: the float32 executer reads another PSNR
    assert ex_t32.test_model(sd) != te_t


@pytest.fixture
def one_thread():
    """One intra-op thread for the test, the count given back after it.
    IOQ's ~190 probes are small renders; at a thread a core beside five
    busy test workers they spent ~800 s waiting on each other's threads,
    against ~30 s alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bf16_compress_ioq_writes_a_bitstream_that_decodes(small_scene,
                                                           tmp_path,
                                                           one_thread):
    """IOQ through a bf16 executer: the given config reaches it, the
    bitstream decodes, and the decoded test views read above 15 dB. Each
    probe renders a batch of 256 rays (the probe's PSNR only ranks the
    candidates; the test views are rendered in full)."""
    scene, sd = small_scene
    bs = str(tmp_path / "bf16.nnc")
    # the given config reaches the executer: the one inferred from the
    # checkpoint (float32) does not take its place
    seen, real = [], tpresets.create_nerf_model_executer

    def recording(**kw):
        seen.append(kw["mlp_config"])
        return real(**kw)

    tpresets.create_nerf_model_executer = recording
    try:
        nnc_tpu_torch.compress_model(sd, bitstream_path=bs, qp=-20, ioq=True,
                                     lsa=False, scene=scene, mlp_config=MLP_T,
                                     use_fused_mlp=True, n_samples=N_SAMPLES,
                                     N_rand=256, device="cpu", verbose=False)
    finally:
        tpresets.create_nerf_model_executer = real
    assert seen == [MLP_T]
    rec = nnc_tpu_torch.decompress(bs, verbose=False)
    assert set(rec) == set(sd)
    _ex_j, ex_t = _executers(scene)
    psnr = ex_t.test_model(rec)
    assert np.isfinite(psnr) and psnr > 15


def test_bf16_full_width_render_routes_to_the_bf16_plain_versions():
    """render_rays at full width with fused compositing: the coarse and the
    fine pass take K-B2's bf16 plain version (the float32 one is swapped for
    a function that raises), and raw_noise_std > 0 routes to K-B3's."""
    _cfg32, _cfg16, _jp, _jls, model = _net({}, 3, False, activate=True)
    ro, rd, vd, _z = (torch.from_numpy(a) for a in _rays(8, 8, seed=4))
    rc = trenderer.RenderConfig(mlp=model.config, n_samples=8,
                                n_importance=8, use_fused_mlp=True,
                                use_fused_compositing=True, fusion_ray_tile=4)

    def refuse(*a, **k):
        raise AssertionError("the float32 version ran for a bf16 model")

    real = (render_fused.render_pass, mlp_fused.mlp_from_points)
    render_fused.render_pass, mlp_fused.mlp_from_points = refuse, refuse
    try:
        with torch.no_grad():
            fused = trenderer.render_rays(model, model, ro, rd, vd, 2.0, 6.0,
                                          rc, deterministic=True)
            import dataclasses
            noisy = trenderer.render_rays(
                model, model, ro, rd, vd, 2.0, 6.0,
                dataclasses.replace(rc, raw_noise_std=1.0),
                deterministic=True)
            plain = trenderer.render_rays(
                model, model, ro, rd, vd, 2.0, 6.0,
                dataclasses.replace(rc, use_fused_mlp=False,
                                    use_fused_compositing=False),
                deterministic=True)
    finally:
        render_fused.render_pass, mlp_fused.mlp_from_points = real
    for out in (fused, noisy):
        assert bool(torch.isfinite(out["rgb_map"]).all())
        assert float((out["rgb_map"] - plain["rgb_map"]).abs().max()) < 5e-3


def test_bf16_render_rays_fused_culled_matches_jax():
    """render_rays at full width with fused compositing, empty-ray culling
    and early termination, 64 rays, 16 + 16 samples, both packages in bf16
    (the reference through its Pallas kernel's bf16 body): every ray within
    the culled render's 5e-3 (tests/test_torch_port_slice.py) and, over the
    rays, within half the reference's own bf16-to-float32 distance (rms; its
    max for the max)."""
    cfg32, cfg16, jp_c, _ls, model_c = _net({}, 0, False, activate=True)
    _c32, _c16, jp_f, _ls, model_f = _net({}, 1, False, activate=True)
    rng = np.random.default_rng(6)
    R = 64
    ro = (0.1 * rng.standard_normal((R, 3))).astype(np.float32)
    rd = (0.2 * rng.standard_normal((R, 3)) + [0, 0, -1.0]).astype(np.float32)
    rd[::3] = [0.0, 0.0, 1.0]  # looking away from the fog: empty rays
    vd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    common = dict(n_samples=16, n_importance=16, perturb=False,
                  use_fused_mlp=True, use_fused_compositing=True,
                  early_term_eps=1e-4, empty_ray_eps=1e-3)
    reference = lambda cfg: jrenderer.render_rays(
        jp_c, jp_f, None, None, jnp.asarray(ro), jnp.asarray(rd),
        jnp.asarray(vd), 2.0, 6.0, jax.random.PRNGKey(9),
        jrenderer.RenderConfig(mlp=cfg, **common), deterministic=True)
    want16, want32 = reference(cfg16), reference(cfg32)
    t = torch.from_numpy
    with torch.no_grad():
        got = trenderer.render_rays(
            model_c, model_f, t(ro), t(rd), t(vd), 2.0, 6.0,
            trenderer.RenderConfig(mlp=model_c.config, **common),
            deterministic=True)
    for k in ("rgb_map", "rgb0"):
        a, w16, w32 = got[k].numpy(), np.asarray(want16[k]), \
            np.asarray(want32[k])
        err, dist = a - w16, w16 - w32
        assert np.abs(err).max() < 5e-3, (k, np.abs(err).max())
        assert 0 < _rms(err) <= _rms(dist) / 2, (k, _rms(err), _rms(dist))
        assert np.abs(err).max() <= np.abs(dist).max(), k
    np.testing.assert_allclose(got["acc_map"].numpy(),
                               np.asarray(want16["acc_map"]), atol=5e-3)


# the entry ------------------------------------------------------------------------------
def test_graft_entry_bf16_matches_the_reference_entry():
    """entry() computes in bf16 by default, as __graft_entry__.entry() does:
    the reference's function on its own weights (carried across by
    from_jax_params) and 16 of its rays, against the port's."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__ as reference
    fn_j, (p_c, p_f, ls_c, ls_f, rays_o, rays_d) = reference.entry()
    n = 16
    want = np.asarray(fn_j(p_c, p_f, ls_c, ls_f, rays_o[:n], rays_d[:n]))
    fn, (model_c, model_f, ro, rd) = graft_entry.entry(n_rays=n, device="cpu")
    assert model_c.config.compute_dtype == BF16_T
    np.testing.assert_array_equal(ro.numpy(), np.asarray(rays_o[:n]))
    np.testing.assert_array_equal(rd.numpy(), np.asarray(rays_d[:n]))
    np_tree = lambda p: jax.tree.map(np.asarray, p)
    cfg = model_c.config
    models = [tnerf.from_jax_params(np_tree(p), cfg, ls=np_tree(ls))
              for p, ls in ((p_c, ls_c), (p_f, ls_f))]
    got = fn(*models, ro, rd)
    assert got.shape == (n, 3) and bool(torch.isfinite(got).all())
    # the same weights in float32: the distance bf16 is allowed to sit at
    fn32, _ = graft_entry.entry(n_rays=n, device="cpu",
                                compute_dtype=torch.float32)
    f32_models = [tnerf.from_jax_params(np_tree(p), tnerf.NeRFConfig(),
                                        ls=np_tree(ls))
                  for p, ls in ((p_c, ls_c), (p_f, ls_f))]
    dist = np.abs(want - fn32(*f32_models, ro, rd).numpy()).max()
    # (the entry's untrained networks render little but the white
    # background: the distance itself is a few float32 ulps of 1, so one
    # more ulp is allowed beside half of it)
    assert dist > 0
    assert np.abs(got.numpy() - want).max() <= dist / 2 + 1e-6
    # its own seeded models run too
    own = fn(model_c, model_f, ro, rd)
    assert bool(torch.isfinite(own).all())
