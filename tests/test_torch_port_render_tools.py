"""The port's render-side tools (nnc_tpu_torch/tools/bench_render_v2,
tune_fast_mode, profile_fast_frame and their shared render_work) on the CPU,
where the kernels' wrappers run their plain versions.

Each tool's measurement function runs at a small size on a full-width solid
teacher (the kernels' architecture) carried from the JAX package's weights
(``from_jax_params``), and its deviation and count outputs are held to the
same computation through nnc_tpu (``renderer.render_chunk``,
``occupancy.render_rays_fast`` on the same grid; K-B2's and K-B3's Pallas
kernels in interpret mode), in float32:
  * max / mean deviations within 1e-5 absolute, devPSNR within 0.05 dB;
  * the active-ray fraction equal;
  * K-B2's points needed and computed equal to those counted here with
    numpy from the reference's selection and MLP (its tiling: tiles of
    ``RAY_TILE`` rays, blocks of ``SAMPLE_BLOCK`` samples; for the packed
    render pass of compacted rows, ``PACKED_POINTS`` a tile of
    floor(``PACKED_POINTS`` / k) rays of filled count k).
Each tool's ``main()`` runs at ``--hw``-sized frames with grids at res 16
(at 128 the full-width plain MLP sweeps 2.5 TFLOP).
"""
import math
import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nnc_tpu.data import synthetic as jsynthetic
from nnc_tpu.models import nerf as jnerf
from nnc_tpu.ops.posenc import positional_encoding as jposenc
from nnc_tpu.render import occupancy as jocc
from nnc_tpu.render import renderer as jrenderer
from nnc_tpu_torch.models import nerf as tnerf
from nnc_tpu_torch.ops import render_fused
from nnc_tpu_torch.render import occupancy as tocc
from nnc_tpu_torch.tools import (bench_render_v2, profile_fast_frame,
                                 render_work, tune_fast_mode)
from nnc_tpu_torch.utils import platform

NEAR, FAR = 2.0, 6.0
COLOUR_BRANCH = ("feature_linear", "views_linears.0", "rgb_linear")
# the reference's default points (tools/tune_fast_mode.py:81-83):
# (C, B, sub, s_blk, r_t)
REFERENCE_POINTS = [(64, 16, 4, 8, 128), (96, 48, 4, 8, 128),
                    (64, 16, 4, 16, 128), (64, 16, 8, 8, 128),
                    (96, 16, 4, 8, 128), (64, 16, 4, 8, 64)]


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny sizes: one intra-op thread keeps the tools fast beside other
    test workers; later tests in this worker get the count back."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def teacher():
    """The solid teacher with N(0, 1e-2) on the weights of its colour
    branch (its density stays the octahedron's, its colour varies with the
    point and the view), as the JAX pytree and the port's float32 model of
    the same numpy weights."""
    cfg = jnerf.NeRFConfig()
    params = jax.tree.map(np.asarray, jsynthetic.make_solid_mlp(cfg))
    rng = np.random.default_rng(18)
    for name in COLOUR_BRANCH:
        w = params[name]["w"]
        params[name]["w"] = (w + 1e-2 * rng.standard_normal(w.shape)) \
            .astype(np.float32)
    model = tnerf.from_jax_params(params, tnerf.NeRFConfig())
    return cfg, jax.tree.map(jnp.asarray, params), model


def _rays(H, W):
    ro, rd = render_work.frame_rays(H, W, "cpu")
    return ro, rd, jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy())


def _sigma_jax(params, cfg, pts, vd):
    """relu(sigma) of the reference's MLP at points (..., 3), directions
    (..., 3)."""
    raw = jnerf.apply_mlp(params, jposenc(jnp.asarray(pts), 10),
                          jposenc(jnp.asarray(vd), 4), cfg)
    return np.maximum(np.asarray(raw[..., 3]), 0.0)


def _work(sigma, dists, flags, term, tile=render_fused.RAY_TILE,
          sb=render_fused.SAMPLE_BLOCK):
    """(needed, computed) of one K-B2 launch in numpy: a live tile holds a
    flagged ray; a sample is needed when its ray is live, its dist not 0 and
    the optical depth before it below ``term``; a block of a tile is
    computed when one of its samples is live with a dist and the tile's
    smallest optical depth at the block's start is below ``term``."""
    R, S = sigma.shape
    live = np.repeat(flags.reshape(-1, tile).any(axis=1), tile)
    tau = np.cumsum(sigma * dists, axis=1, dtype=np.float32)
    before = np.concatenate([np.zeros((R, 1), np.float32), tau[:, :-1]], 1)
    on = live[:, None] & (dists > 0)
    needed = int(((before < term) & on).sum())
    computed = 0
    for r0 in range(0, R, tile):
        for s0 in range(0, S, sb):
            if on[r0:r0 + tile, s0:s0 + sb].any() and \
                    before[r0:r0 + tile, s0].min() < term:
                computed += tile * sb
    return needed, computed


def _packed_points(dists, flags):
    """The points the packed render pass computes in numpy: the rays of
    filled count k (flagged, dists > 0) in tiles of floor(64 / k) rays, 64
    points a tile."""
    counts = (dists > 0).sum(axis=1) * flags
    n = np.bincount(counts, minlength=render_fused.SAMPLE_BLOCK + 1)
    P = render_fused.PACKED_POINTS
    return P * sum(-(-int(n[k]) // (P // k)) for k in range(1, len(n)))


# -- bench_render_v2 ---------------------------------------------------------
def test_bench_render_v2_deviations_match_jax(teacher):
    """The ladder at 8x16 rays, 32 + 64 samples: each fused route's max /
    mean deviation from the plain route and the active-ray fraction equal
    the reference's (its routes through render_chunk); the coarse K-B2
    launch's points equal those counted from the reference's MLP, and
    without early termination every point is needed and computed."""
    cfg, params, model = teacher
    ro, rd, jro, jrd = _rays(8, 16)
    S0, S1 = 32, 64
    got = bench_render_v2.measure(model, model, ro, rd, iters=1, check=True,
                                  n_samples=S0, n_importance=S1)
    rcs = bench_render_v2.route_configs(cfg, ro.shape[0], S0, S1)
    want = {}
    for name, rc_t in rcs.items():
        rc_j = jrenderer.RenderConfig(**{
            f: getattr(rc_t, f) for f in (
                "n_samples", "n_importance", "white_bkgd", "chunk",
                "use_fused_mlp", "use_fused_compositing", "early_term_eps",
                "empty_ray_eps", "fusion_ray_tile", "fusion_sample_block")},
            mlp=cfg)
        want[name] = jrenderer.render_chunk(
            params, params, None, None, jro, jrd, NEAR, FAR,
            jax.random.PRNGKey(0), rc_j, True)
    base = np.asarray(want["plain"]["rgb_map"])
    assert got["active_fraction"] == float(
        (np.asarray(want["plain"]["acc_map"]) > 1e-3).mean())
    assert 0.05 < got["active_fraction"] < 0.95
    for name in bench_render_v2.ROUTES[1:]:
        d = np.abs(np.asarray(want[name]["rgb_map"]) - base)
        assert abs(got[name]["maxdev"] - d.max()) <= 1e-5, name
        assert abs(got[name]["meandev"] - d.mean()) <= 1e-5, name
    assert got["fused_et_64x32"]["maxdev"] > 0
    assert got["plain"]["points"] == got["fused_mlp"]["points"] == []
    R = ro.shape[0]
    assert got["fused_noet"]["points"] == [(S0, R * S0, R * S0),
                                           (S0 + S1, R * (S0 + S1),
                                            R * (S0 + S1))]
    # the coarse launch of the early-terminated route, from the reference
    z = np.asarray(NEAR * (1.0 - jnp.linspace(0.0, 1.0, S0))
                   + FAR * jnp.linspace(0.0, 1.0, S0))[None].repeat(R, 0)
    rd_np = rd.numpy()
    dists = np.concatenate([z[:, 1:] - z[:, :-1],
                            np.full((R, 1), 1e10, np.float32)], 1) \
        * np.linalg.norm(rd_np, axis=-1, keepdims=True)
    vd = rd_np / np.linalg.norm(rd_np, axis=-1, keepdims=True)
    pts = ro.numpy()[:, None, :] + rd_np[:, None, :] * z[..., None]
    sigma = _sigma_jax(params, cfg, pts, np.broadcast_to(
        vd[:, None, :], pts.shape))
    coarse = got["fused_et_64x32"]["points"][0]
    assert coarse == (S0, *_work(sigma, dists.astype(np.float32),
                                 np.ones(R, bool), -math.log(1e-4)))
    assert coarse[1] < R * S0
    fine = got["fused_et_64x32"]["points"][1]
    assert fine[0] == S0 + S1 and 0 < fine[1] <= fine[2] < R * (S0 + S1)


# -- tune_fast_mode ----------------------------------------------------------
def test_tune_fast_mode_points_merge_tpu_tiles_with_one_warning():
    with pytest.warns(UserWarning, match="s_blk / r_t") as caught:
        points = tune_fast_mode.parse_points(",".join(
            ":".join(map(str, p)) for p in REFERENCE_POINTS))
    assert len(caught) == 1
    # the reference's six points are the port's four default ones
    assert points == list(tune_fast_mode.DEFAULT_POINTS) == \
        [(64, 16, 4), (96, 48, 4), (64, 16, 8), (96, 16, 4)]
    assert tune_fast_mode.parse_points(None) == points
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert tune_fast_mode.parse_points("96:48:4,64:16:4,96:48:4") == \
            [(96, 48, 4), (64, 16, 4)]
    with pytest.raises(ValueError, match="C:B:sub"):
        tune_fast_mode.parse_points("64:16")


def _jax_fast_work(params, cfg, grid, ro, rd, layout, C, B, fac):
    """The compacted launch's (needed, computed), counted from the
    reference's selection (``_select_sub``), its block sort and its MLP;
    at most ``SAMPLE_BLOCK`` slots a ray run the packed render pass."""
    H, W = layout
    Ws = W // fac
    nb = fac * fac
    z_s, dists_s, any_s = (np.asarray(a) for a in jocc._select_sub(
        grid, jnp.asarray(ro), jnp.asarray(rd), NEAR, FAR, C, B, layout,
        fac))
    counts = (dists_s > 0).sum(axis=-1)
    order = np.argsort(-counts, kind="stable")
    by, bx = order // Ws, order % Ws
    offs = (np.arange(fac)[:, None] * W + np.arange(fac)[None, :]).reshape(-1)
    idx = ((by * fac * W + bx * fac)[:, None] + offs[None, :]).reshape(-1)
    ro_s, rd_s = ro[idx], rd[idx]
    z = np.repeat(z_s[order], nb, axis=0)
    dists = np.repeat(dists_s[order], nb, axis=0) \
        * np.linalg.norm(rd_s, axis=-1, keepdims=True)
    flags = np.repeat(any_s[order], nb)
    vd = rd_s / np.linalg.norm(rd_s, axis=-1, keepdims=True)
    pts = ro_s[:, None, :] + rd_s[:, None, :] * z[..., None]
    sigma = _sigma_jax(params, cfg, pts,
                       np.broadcast_to(vd[:, None, :], pts.shape))
    needed, computed = _work(sigma, dists.astype(np.float32), flags,
                             -math.log(1e-4))
    if B <= render_fused.SAMPLE_BLOCK:
        computed = _packed_points(dists, flags)
    return needed, computed


def test_tune_fast_mode_sweep_matches_jax(teacher):
    """A 16x32 frame through the reference's res-32 grid (carried to the
    port), the exact frame at 32 + 64 samples: each point's maxdev and
    devPSNR equal the reference's fast render against its exact render,
    and K-B2's points equal those counted from the reference's
    selection."""
    cfg, params, model = teacher
    H, W = 16, 32
    ro, rd, jro, jrd = _rays(H, W)
    jgrid = jocc.build_occupancy_grid(params, None, cfg, res=32,
                                      use_fused=False, chunk=32768)
    grid = tocc.grid_from_arrays(np.asarray(jgrid.occ), jgrid.lo, jgrid.hi,
                                 jgrid.occ_lo, jgrid.occ_hi,
                                 jgrid.open_boundary)
    points = [(48, 16, 4), (64, 8, 2)]
    got = tune_fast_mode.sweep(model, model, grid, ro, rd, (H, W), points,
                               iters=1, floor=True, n_samples=32,
                               n_importance=64)
    assert got["occupied_fraction"] == float(np.asarray(jgrid.occ).mean())
    rc = jrenderer.RenderConfig(
        mlp=cfg, n_samples=32, n_importance=64, white_bkgd=True,
        chunk=H * W, use_fused_mlp=True, use_fused_compositing=True,
        early_term_eps=1e-4, empty_ray_eps=1e-3)
    exact = np.asarray(jrenderer.render_chunk(
        params, params, None, None, jro, jrd, NEAR, FAR,
        jax.random.PRNGKey(0), rc, True)["rgb_map"])
    jvd = jrd / jnp.linalg.norm(jrd, axis=-1, keepdims=True)
    for row, (C, B, fac) in zip(got["points"], points):
        assert (row["C"], row["B"], row["sub"]) == (C, B, fac)
        fast = np.asarray(jocc.render_rays_fast(
            params, None, jro, jrd, jvd, NEAR, FAR, jgrid, rc,
            n_candidates=C, budget=B, layout=(H, W),
            subsample=fac)["rgb_map"])
        d = np.abs(fast.astype(np.float64) - exact)
        assert abs(row["maxdev"] - d.max()) <= 1e-5, (C, B, fac)
        assert abs(row["dev_psnr"]
                   + 10 * np.log10(np.mean(d ** 2) + 1e-12)) <= 0.05
        assert (row["needed"], row["computed"]) == _jax_fast_work(
            params, cfg, jgrid, ro.numpy(), rd.numpy(), (H, W), C, B, fac)
        assert 0 < row["needed"] < row["computed"]
        assert all(np.isfinite(row[k]) and row[k] > 0
                   for k in ("ms", "floor_ms", "rays_per_s"))


# -- profile_fast_frame ------------------------------------------------------
def test_profile_fast_frame_probes_run_in_order(teacher):
    cfg, params, model = teacher
    H, W = 16, 32
    ro, rd, _jro, _jrd = _rays(H, W)
    grid = tocc.build_occupancy_grid(model, res=16)
    seen = []
    real = tocc._select_sub
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tocc, "_select_sub",
                   lambda *a: (seen.append(len(seen)), real(*a))[1])
        t = profile_fast_frame.profile(model, grid, ro, rd, (H, W), iters=1)
    assert t["order"] == list(profile_fast_frame.PROBES)
    assert t["kb2_launches"] == 1
    # select, presort, full and frame each call the selection: one untimed
    # call and one timed call each, then one more full frame for K-B2
    assert len(seen) == 2 * len(profile_fast_frame.PROBES) + 1
    assert all(np.isfinite(t[k]) and t[k] > 0
               for k in profile_fast_frame.PROBES + ("kb2", "gather2",
                                                      "gather2_128"))


# -- each tool's command line ------------------------------------------------
@pytest.fixture
def small_cpu_tools(monkeypatch):
    monkeypatch.setenv(platform.DEVICE_ENV, "cpu")
    build = tocc.build_occupancy_grid
    monkeypatch.setattr(tocc, "build_occupancy_grid",
                        lambda *a, **kw: build(*a, **dict(kw, res=16)))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("tool", ["bench_render_v2", "tune_fast_mode",
                                  "profile_fast_frame"])
def test_tool_main_on_cpu(small_cpu_tools, capsys, tool, dtype):
    argv = {"bench_render_v2": ["--hw", "8", "16", "--iters", "1",
                                "--check"],
            "tune_fast_mode": ["--hw", "16", "32", "--iters", "1",
                               "--points", "48:16:4"],
            "profile_fast_frame": ["--hw", "16", "32", "--iters", "1"]}
    module = {"bench_render_v2": bench_render_v2,
              "tune_fast_mode": tune_fast_mode,
              "profile_fast_frame": profile_fast_frame}[tool]
    res = module.main(argv[tool] + ["--dtype", dtype])
    printed = capsys.readouterr().out
    assert f"device: cpu (cpu), dtype {dtype}" in printed
    if tool == "bench_render_v2":
        assert set(bench_render_v2.ROUTES) <= set(res)
        assert "active-ray fraction" in printed
        assert "K-B2 points needed / computed" in printed
    elif tool == "tune_fast_mode":
        assert "exact:" in printed and "devPSNR" in printed
        assert len(res["points"]) == 1
    else:
        assert "K-B2 inside it" in printed
        assert res["kb2_launches"] == 1
