"""The benchmark's plain reference of occupancy LSA
(``benchmark/reference/nerf_occ.py``) against the port's
``lsa.double_mse_loss_occ`` on the CPU, on a tiny grid: the same random
teachers (``benchmark/scene.py``'s recipe, density shifted so that about half
of the grid is occupied), the same rays and targets, the port's grid handed
to the reference; and a few steps of the port's ``tune_lsa_scales(grid=)``
against the reference's ``follow_lsa`` on the same batches.

Tolerances, float32 on both sides, and why:
  * the reference's own grid against the port's: at most 1% of the voxels
    differ (a voxel whose density sits at the threshold flips with the MLP's
    sums in another order);
  * the selection: z and the spans to 1e-6 relative (the same float32
    arithmetic on the same box);
  * the loss to 2e-6 relative and each scale's gradient to 1e-4 of the
    largest gradient of its layer (the port scales the product, the reference
    the weight: the same values summed in another order);
  * after 3 steps of Adam, each step's loss to 2e-6 relative, as the first
    step's, and the norm of each leaf's change of its scales to 2e-4
    relative (1.9e-5 at most over 4 seeds): Adam's first steps move every
    element by about the learning rate whatever the size of its gradient,
    so an element whose gradient is a rounding error away from 0 may step
    either way on the two sides.
"""
import numpy as np
import pytest
import torch

from benchmark import scene
from benchmark.reference import nerf as ref_nerf
from benchmark.reference import nerf_occ as ref
from nnc_tpu_torch.models import nerf
from nnc_tpu_torch.render import occupancy, renderer
from nnc_tpu_torch.train import lsa
from nnc_tpu_torch.utils.logging import read_result_file

NET = {"netdepth": 8, "netwidth": 32, "skips": [4], "multires": 10,
       "multires_views": 4, "use_viewdirs": True}
GRID = {"res": 16, "lo": [-2.0, -2.0, -2.0], "hi": [2.0, 2.0, 2.0],
        "sigma_threshold": 0.01, "dilate": 0}
OCC = {"n_candidates": 64, "budget": 32}
NEAR, FAR = 2.0, 6.0


def _half_occupied(nets, side: int):
    """``nets`` with both density heads' biases lowered by the median of the
    fine network's raw density at the centres of a ``side``^3 grid over
    GRID's box, less its threshold."""
    axes = [torch.tensor(lo + (np.arange(side, dtype=np.float32) + 0.5)
                         * (hi - lo) / side)
            for lo, hi in zip(GRID["lo"], GRID["hi"])]
    pts = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    vd = torch.zeros_like(pts)
    vd[:, 2] = 1.0
    raw = ref_nerf.mlp_blocks(NET, nets[1], pts, vd)[:, 3]
    shift = float(torch.median(raw)) - GRID["sigma_threshold"]
    for weights in nets:
        weights["alpha_linear"][1].sub_(shift)
    return nets


def _setup(seed):
    nets = _half_occupied(
        scene.uniform_networks(NET, 2, seed, torch.device("cpu")), 8)
    config = nerf.NeRFConfig(D=8, W=32, input_ch=63, input_ch_views=27,
                             skips=(4,))
    models = []
    for weights in nets:
        model = nerf.NeRF(config)
        with torch.no_grad():
            for name, layer in model.layers().items():
                layer.weight.copy_(weights[name][0])
                layer.bias.copy_(weights[name][1])
        models.append(model)
    rc = renderer.RenderConfig(mlp=config, white_bkgd=True,
                               raw_noise_std=0.0)
    return nets, models, rc


def _rays(R, seed):
    g = torch.Generator().manual_seed(seed)
    ro = torch.randn(R, 3, generator=g) * 0.1 + torch.tensor([0., 0., 4.])
    rd = torch.randn(R, 3, generator=g) * 0.2 + torch.tensor([0., 0., -1.])
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    return ro, rd, vd, torch.rand(R, 3, generator=g)


@pytest.mark.parametrize("seed", [3, 11])
def test_reference_occ_loss_and_scale_gradients_match_the_port(seed):
    nets, models, rc = _setup(seed)
    grid = occupancy.build_occupancy_grid(
        models[1], lo=tuple(GRID["lo"]), hi=tuple(GRID["hi"]),
        res=GRID["res"], sigma_threshold=GRID["sigma_threshold"],
        dilate=GRID["dilate"], use_fused=False)
    own = ref.build_grid(NET, nets[1], GRID, torch.device("cpu"))
    occupied = float(own["occ"].float().mean())
    assert 0.05 < occupied < 0.95, occupied
    assert float((own["occ"] != grid.occ).float().mean()) <= 0.01
    as_ref = ref.grid_from_occ(grid.occ, list(grid.lo), list(grid.hi),
                               grid.open_boundary)

    ro, rd, vd, tgt = _rays(64, seed)
    z_p, dists_p, _ = occupancy.select_occupied_samples(
        grid, ro, rd, NEAR, FAR, OCC["n_candidates"], OCC["budget"])
    z_r, dists_r = ref.select_rays(as_ref, ro, rd, NEAR, FAR,
                                   OCC["n_candidates"], OCC["budget"])
    assert float((dists_r > 0).float().mean()) > 0.1
    torch.testing.assert_close(z_p, z_r, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(dists_p, dists_r, rtol=1e-6, atol=1e-6)

    lsa.trained_tensors(*models)
    loss, img = lsa.double_mse_loss_occ(*models, ro, rd, vd, tgt, NEAR, FAR,
                                        rc, grid, OCC["n_candidates"],
                                        OCC["budget"])
    loss.backward()
    scales = tuple({name: torch.ones(w.shape[0], 1, requires_grad=True)
                    for name, (w, _b) in weights.items()} for weights in nets)
    render = {"near": NEAR, "far": FAR, "white_bkgd": True}
    want, want_img = ref.train_loss(NET, render, nets, scales,
                                    (ro, rd, vd, tgt), as_ref, OCC)
    want.backward()
    np.testing.assert_allclose(loss.item(), want.item(), rtol=2e-6)
    np.testing.assert_allclose(img.item(), want_img.item(), rtol=2e-6)
    for model, leaves in zip(models, scales):
        for name, layer in model.layers().items():
            got = layer.weight_scaling.grad.reshape(-1)
            exp = leaves[name].grad.reshape(-1)
            bar = 1e-4 * float(exp.abs().max())
            assert float((got - exp).abs().max()) <= bar, name
    assert any(float(l.grad.abs().max()) > 0 for leaves in scales
               for l in leaves.values())


class _Batches:
    """The batcher interface of ``tune_lsa_scales`` over fixed batches."""

    def __init__(self, batches):
        self.batches, self.at = batches, 0

    def next_batch(self):
        self.at += 1
        return tuple(t.numpy() for t in self.batches[self.at - 1])


@pytest.mark.parametrize("seed", [5, 13])
def test_reference_follows_the_ports_occupancy_lsa(seed, tmp_path):
    nets, models, rc = _setup(seed)
    grid = occupancy.build_occupancy_grid(
        models[1], lo=tuple(GRID["lo"]), hi=tuple(GRID["hi"]),
        res=GRID["res"], sigma_threshold=GRID["sigma_threshold"],
        dilate=GRID["dilate"], use_fused=False)
    as_ref = ref.grid_from_occ(grid.occ, list(grid.lo), list(grid.hi),
                               grid.open_boundary)
    batches = [_rays(32, 100 * seed + i) for i in range(3)]
    lr = 1e-3
    ls_c, ls_f, *_ = lsa.tune_lsa_scales(
        *models, _Batches(batches), rc, NEAR, FAR, learning_rate=lr,
        learning_rate_decay=0.0, epochs=1, n_iters=3, steps_per_call=1,
        verbose=False, basedir_save=str(tmp_path), grid=grid,
        occ_candidates=OCC["n_candidates"], occ_budget=OCC["budget"])
    losses = read_result_file(str(tmp_path / "result.txt"))[1]
    render = {"near": NEAR, "far": FAR, "white_bkgd": True}
    want = ref.follow_lsa(NET, render, nets, batches, as_ref, OCC, lr)
    np.testing.assert_allclose(losses, want["losses"], rtol=2e-6)
    got = {f"{tag}.{name}": float(torch.linalg.norm(t - 1.0))
           for tag, ls in zip("cf", (ls_c, ls_f)) for name, t in ls.items()}
    assert set(got) == set(want["change"])
    for leaf, change in want["change"].items():
        assert change > 0, leaf
        np.testing.assert_allclose(got[leaf], change, rtol=2e-4,
                                   err_msg=leaf)
