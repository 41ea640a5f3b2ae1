"""K-B2's packed render pass (``render_fused.fused_render_pass_packed``,
occupancy mode's float32 route for rows of at most ``SAMPLE_BLOCK`` slots)
on the CPU, where its wrapper runs the plain version:
  * the plain version against ``fused_render_pass_plain`` on the same
    compacted rows (one block a ray, culling per ray): rgb / acc within
    1e-6, depth within 1e-6 x far (it sums w z, z < 6). Both run the MLP on
    the same batch of points and composite the same filled slots from an
    optical depth of 0; they part only in the order of their sums (a few
    ulps). Rays without a filled slot and culled rays read exact zeros;
  * the plan (``packed_bounds``, ``packed_plan``) against a histogram
    counted here: every ray with a filled slot in exactly one tile, with
    the rays of its count, no tile over 64 points, sum_k ceil(n_k /
    floor(64 / k)) tiles;
  * which entry occupancy mode, the exact renderer and bf16 take;
  * a traced frame's ``nnc.frame.kb2`` span counts: its ``slots`` and
    ``points`` are the plan's on the frame's own selection.
"""
import math

import numpy as np
import pytest
import torch

from nnc_tpu_torch.data import synthetic
from nnc_tpu_torch.models import nerf
from nnc_tpu_torch.ops import mlp_fused, render_fused
from nnc_tpu_torch.render import occupancy, renderer
from nnc_tpu_torch.render.rays import get_rays_np
from nnc_tpu_torch.utils import profiling

TERM = -math.log(1e-4)   # occupancy mode's early termination
FAR = 6.0
KB2 = ("render_pass", "render_pass_bf16", "render_pass_packed")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def solid():
    model = synthetic.make_solid_mlp(noise_std=1e-2, generator=torch
                                     .Generator().manual_seed(3))
    return model, mlp_fused.pack_weights(model)


def _compacted(R, S, seed, scattered=False, culled=3):
    """R rays toward the solid with S compacted slots, in non-increasing
    order of their filled counts (0..S, each count drawn); the filled slots
    a prefix of the row, or ``scattered`` over it; the last ``culled`` rays
    culled (live 0) though their dists are not all 0. Returns (ro, rd, vd,
    z, dists, live)."""
    g = torch.Generator().manual_seed(seed)
    ro = 0.1 * torch.randn(R, 3, generator=g) + torch.tensor([0, 0, 4.0])
    rd = 0.2 * torch.randn(R, 3, generator=g) + torch.tensor([0, 0, -1.0])
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    z, _ = torch.sort(2 + 4 * torch.rand(R, S, generator=g), dim=-1)
    counts, _ = torch.sort(torch.randint(0, S + 1, (R,), generator=g),
                           descending=True)
    if scattered:
        keys = torch.rand(R, S, generator=g)
        rank = keys.argsort(dim=1).argsort(dim=1)
        filled = rank < counts[:, None]
    else:
        filled = torch.arange(S)[None, :] < counts[:, None]
    dists = torch.where(filled, 0.02 + 0.2 * torch.rand(R, S, generator=g),
                        0.0)
    live = (counts > 0).to(torch.int32)
    if culled:
        dists[-culled:, 0] = 0.1
        live[-culled:] = 0
    return ro, rd, vd, z, dists, live


@pytest.mark.parametrize("scattered", [False, True],
                         ids=["prefix", "scattered"])
@pytest.mark.parametrize("S", [1, 7, 16, 32])
def test_packed_plain_matches_render_pass_plain(solid, S, scattered):
    _model, packed = solid
    args = _compacted(300, S, seed=S, scattered=scattered)
    stats = torch.zeros(2, dtype=torch.int64)
    got = render_fused.render_pass_packed(packed, *args, TERM, stats=stats)
    want = render_fused.fused_render_pass_plain(
        packed, *args, TERM, want_weights=False, ray_tile=1)[0]
    assert float((got[:, :4] - want[:, :4]).abs().max()) <= 1e-6
    assert float((got[:, 4] - want[:, 4]).abs().max()) <= 1e-6 * FAR
    dists, live = args[4], args[5]
    empty = ((dists > 0).sum(dim=1) == 0) | (live == 0)
    assert int(empty.sum()) >= 3 and bool((got[empty] == 0).all())
    assert float(got[:, 3].max()) > 0.5   # rays reach the solid
    counts = render_fused.filled_counts(dists, live, TERM)
    tiles = render_fused.packed_plan(render_fused.packed_bounds(counts, S))
    assert stats.tolist() == [int(counts.sum()),
                              render_fused.PACKED_POINTS * len(tiles)]


@pytest.mark.parametrize("S", [1, 7, 16, 32])
def test_packed_plan_holds_each_live_ray_once(S):
    g = torch.Generator().manual_seed(100 + S)
    R = 1000
    counts, _ = torch.sort(torch.randint(0, S + 1, (R,), generator=g,
                                         dtype=torch.int32), descending=True)
    counts[-50:] = 0   # rays without a filled slot
    bounds = render_fused.packed_bounds(counts, S)
    n = np.bincount(counts.numpy(), minlength=S + 1)
    assert bounds.dtype == torch.int32 and bounds.tolist() == [
        int(n[k + 1:].sum()) for k in range(S + 1)]
    tiles = render_fused.packed_plan(bounds)
    P = render_fused.PACKED_POINTS
    assert len(tiles) == sum(-(-int(n[k]) // (P // k))
                             for k in range(1, S + 1))
    seen = np.zeros(R, int)
    for r0, rays, k in tiles:
        assert 1 <= rays <= P // k and rays * k <= P
        assert bool((counts[r0:r0 + rays] == k).all())
        seen[r0:r0 + rays] += 1
    assert (seen == (counts.numpy() > 0)).all()


def test_packed_pass_refuses_what_it_cannot_run(solid):
    model, packed = solid
    ro, rd, vd, z, dists, live = _compacted(40, 16, seed=5, culled=0)
    with pytest.raises(ValueError, match="non-increasing"):
        render_fused.render_pass_packed(packed, ro, rd, vd, z,
                                        dists.flip(0), live.flip(0), TERM)
    wide = z.repeat(1, 3)[:, :33]
    with pytest.raises(ValueError, match="1 to 32 slots"):
        render_fused.render_pass_packed(packed, ro, rd, vd, wide, wide, live,
                                        TERM)
    with pytest.raises(ValueError, match="stats"):
        render_fused.render_pass_packed(packed, ro, rd, vd, z, dists, live,
                                        TERM, stats=torch.zeros(2))
    bf16 = synthetic.make_solid_mlp(nerf.NeRFConfig(
        compute_dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="float32 model"):
        render_fused.fused_render_pass_packed(bf16, ro, rd, vd, z, dists)
    # no block runs where term_csd <= 0 (early_term_eps 1): zeros
    stats = torch.ones(2, dtype=torch.int64)
    maps = render_fused.render_pass_packed(packed, ro, rd, vd, z, dists,
                                           live, 0.0, stats=stats)
    assert bool((maps == 0).all()) and stats.tolist() == [0, 0]


def _frame(hw=16):
    K = np.array([[0.8 * hw, 0, hw / 2], [0, 0.8 * hw, hw / 2], [0, 0, 1]],
                 np.float32)
    ro, rd = get_rays_np(hw, hw, K, synthetic.look_at_poses(1)[0, :3, :4])
    return ro, rd


@pytest.fixture(scope="module")
def scene():
    model = synthetic.make_solid_mlp(radius=1.0)
    return model, occupancy.build_occupancy_grid(model, res=16)


@pytest.mark.parametrize("layout", [None, (16, 16)], ids=["per_ray", "tiled"])
def test_occupancy_takes_the_packed_pass_in_float32_up_to_32_slots(
        scene, monkeypatch, layout):
    model, grid = scene
    model16 = synthetic.make_solid_mlp(
        nerf.NeRFConfig(compute_dtype=torch.bfloat16), radius=1.0)
    ro, rd = (torch.as_tensor(a.reshape(-1, 3)) for a in _frame())
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    calls = []
    for name in KB2:
        real = getattr(render_fused, name)
        monkeypatch.setattr(render_fused, name,
                            lambda *a, _n=name, _r=real, **kw:
                            (calls.append(_n), _r(*a, **kw))[1])

    def took(m, budget, n_candidates=48):
        calls.clear()
        rc = renderer.RenderConfig(mlp=m.config, white_bkgd=True)
        out = occupancy.render_rays_fast(
            m, ro, rd, vd, 2.0, 6.0, grid, rc, n_candidates=n_candidates,
            budget=budget, layout=layout)
        assert float(out["acc_map"].max()) > 0.5
        return list(calls)

    assert took(model, 16) == ["render_pass_packed"]
    assert took(model, 32) == ["render_pass_packed"]
    assert took(model, 64, n_candidates=96) == ["render_pass"]
    assert took(model16, 16) == ["render_pass_bf16"]
    calls.clear()
    fused = renderer.RenderConfig(mlp=model.config, n_samples=16,
                                  n_importance=16, white_bkgd=True,
                                  use_fused_mlp=True,
                                  use_fused_compositing=True)
    with torch.no_grad():
        renderer.render_rays(model, model, ro[:64], rd[:64], vd[:64], 2.0,
                             6.0, fused, deterministic=True)
    assert calls == ["render_pass", "render_pass"]


def test_traced_frame_counts_the_packed_tiles(scene):
    """The frame's one kb2 span counts the filled slots and the plan's
    points of its own selection (``_select_sub``, the blocks sorted by
    count, 16 rays a block); untraced, no counts wait to be read."""
    model, grid = scene
    ro, rd = _frame()
    rc = renderer.RenderConfig(mlp=model.config, white_bkgd=True)
    kw = dict(n_candidates=48, budget=16, subsample=4)
    profiling.settle_counts()
    untraced = occupancy.render_image_fast(model, ro, rd, 2.0, 6.0, rc, grid,
                                           **kw)
    assert len(profiling._LATER) == 0
    with profiling.trace_if(None):
        traced = occupancy.render_image_fast(model, ro, rd, 2.0, 6.0, rc,
                                             grid, **kw)
    for k in untraced:
        np.testing.assert_array_equal(traced[k], untraced[k])
    frame = [s for s in profiling.spans() if s.name == "nnc.frame"][-1]
    kb2 = [s for s in profiling.spans()
           if s.name == "nnc.frame.kb2" and s.parent == frame.index]
    assert len(kb2) == 1 and len(profiling._LATER) == 0
    t = lambda a: torch.as_tensor(a.reshape(-1, 3))
    _z, dists_s, _any = occupancy._select_sub(grid, t(ro), t(rd), 2.0, 6.0,
                                              48, 16, (16, 16), 4)
    counts, _ = torch.sort((dists_s > 0).sum(dim=1, dtype=torch.int32),
                           descending=True)
    counts = counts.repeat_interleave(16)
    tiles = render_fused.packed_plan(render_fused.packed_bounds(counts, 16))
    assert kb2[0].counts == {"slots": int(counts.sum()),
                             "points": render_fused.PACKED_POINTS
                             * len(tiles)}
    assert 0 < kb2[0].counts["slots"] <= kb2[0].counts["points"]
