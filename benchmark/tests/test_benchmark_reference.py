"""The plain reference at tiny sizes on the CPU."""
import math

import numpy as np
import torch

from benchmark import harness, scene
from benchmark.reference import nerf as ref

CFG = harness.load_json(harness.HERE, "configs", "lego.json")
NET = CFG["net"]
TEACHER = {"radius": 1.5, "density": 100.0, "rgb": [0.6, 0.2, -0.4],
           "noise_std": 0.0}


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.0 - 2 ** -12], dtype=torch.float32)
    want = [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -3.0]
    assert ref.round_tf32(x).tolist() == want


def test_solid_teacher_density():
    (w,) = scene.solid_networks(NET, TEACHER, 1, 3, "cpu")
    pts = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.2, 0.1], [2.0, 0.0, 0.0]])
    raw = ref.mlp(NET, w, pts, torch.tensor([[0.0, 0.0, 1.0]] * 3))
    sigma = raw[:, 3].tolist()
    assert math.isclose(sigma[0], 150.0, rel_tol=1e-6)
    assert math.isclose(sigma[1], 70.0, rel_tol=1e-5)
    assert sigma[2] <= 0.0
    assert torch.allclose(raw[:, :3], torch.tensor(TEACHER["rgb"]).expand(3, 3))


def test_render_view_sees_the_solid_and_counts_its_points():
    nets = scene.solid_networks(NET, TEACHER, 2, 3, "cpu")
    cam = dict(CFG["camera"], H=8, W=8, focal=10.0)
    ro, rd = scene.rays_np(8, 8, scene.intrinsics(cam),
                           scene.look_at(0.3, 0.1, 4.0))
    render = dict(CFG["render"], N_samples=16, N_importance=16, chunk=64)
    rgb, acc, needed = ref.render_view(
        NET, render, nets, torch.as_tensor(ro.reshape(-1, 3)),
        torch.as_tensor(rd.reshape(-1, 3)))
    assert acc.max() > 0.99 and acc.min() < 1e-3       # object and sky
    assert 64 * 16 <= needed <= 64 * 16 + int((acc > 1e-3).sum()) * 32
    sky = acc < 1e-6
    assert torch.allclose(rgb[sky], torch.ones_like(rgb[sky]))


def test_follow_lsa_moves_every_leaf_and_tf32_differs():
    nets = scene.solid_networks(NET, dict(TEACHER, noise_std=0.01), 2, 5,
                                "cpu")
    n = 16
    g = torch.Generator().manual_seed(0)
    batches = [(torch.zeros(n, 3) + torch.tensor([0.0, 0.0, 4.0]),
                torch.randn(n, 3, generator=g) * 0.1
                + torch.tensor([0.0, 0.0, -1.0]), None,
                torch.rand(n, 3, generator=g)) for _ in range(3)]
    batches = [(o, d, d / d.norm(dim=-1, keepdim=True), t)
               for o, d, _v, t in batches]
    samp = {"N_samples": 8, "N_importance": 8}
    draws = scene.training_draws(3, n, samp, False, 1, "cpu")
    render = dict(samp, near=2.0, far=6.0, white_bkgd=True,
                  raw_noise_std=0.0)
    a = ref.follow_lsa(NET, render, nets, batches, draws, 1e-4)
    b = ref.follow_lsa(NET, render, nets, batches, draws, 1e-4, tf32=True)
    assert len(a["losses"]) == 3 and np.all(np.isfinite(a["losses"]))
    assert all(v > 0 for v in a["change"].values())
    assert a["losses"] != b["losses"]


def test_reference_batches_are_the_program_batchers():
    """The reference works the program's batches out again from the
    batcher's seed, in both modes, across the pool's reshuffle."""
    from nnc_tpu_torch.data.rays import RayBatcher
    from benchmark.drivers import lsa
    cam = {"rig": "look_at", "radius": 4.0, "H": 6, "W": 5, "focal": 7.0}
    images, poses, K = scene.training_views(cam, 3, 11)
    for mode, n in (("image", 4), ("pool", 9)):      # a pass is 90 // 16
        batcher = RayBatcher(images, poses, K, np.arange(3), 16, mode=mode,
                             seed=21)
        want = lsa.reference_batches(images, poses, K, 16, mode, 21, n, cam,
                                     ndc=False)
        for (ro, rd, _vd, t) in want:
            got = batcher.next_batch()
            assert all(np.allclose(a, b, atol=1e-6)
                       for a, b in zip(got, (ro, rd, t))), mode


def test_the_pools_window_holds_whole_passes():
    from benchmark.drivers import lsa
    assert lsa.window_steps(30, 0.01, 8, 25) == 3000
    # 3,162 batches a pass, 25 compared: the window ends just after the
    # first reshuffle, at batch 3,162 (0-based), in whole calls of 8
    n = lsa.window_steps(30, 0.0095, 8, 25, epoch=3162)
    assert n % 8 == 0 and 25 + n - 8 < 3162 + 1 <= 25 + n
    n = lsa.window_steps(60, 0.0095, 8, 25, epoch=3162)
    assert 25 + n - 8 < 2 * 3162 + 1 <= 25 + n
    # nearer no pass: steps before the first reshuffle only
    n = lsa.window_steps(5, 0.0095, 8, 25, epoch=3162)
    assert n == 528 and 25 + n <= 3162
