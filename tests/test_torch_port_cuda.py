"""CUDA kernels of nnc_tpu_torch against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one.

This file imports no JAX (the machine with the card has none). Run it there
without the repository's conftest, which imports JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Tolerances, float32 on both sides: raw MLP outputs 1e-3 (12 layers of
K=256 sums in another order); composited rgb/acc/weights 1e-4 with early
termination off, 2 eps with it on (both versions skip the same blocks, up to
threshold ties); depth 10x those (it sums w * z, z <= 6).
"""
import math

import pytest
import torch

from nnc_tpu_torch.data import synthetic
from nnc_tpu_torch.models import nerf
from nnc_tpu_torch.ops import _build, mlp_fused, render_fused
from nnc_tpu_torch.render import renderer


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build with nvcc for "
                    "sm_90a and run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _fog_model(device, seed=0):
    """Random flagship weights with LSA scales and visible density."""
    g = torch.Generator().manual_seed(seed)
    model = synthetic._activate(nerf.init_params(nerf.NeRFConfig(), g), g)
    return nerf.init_lsa_scales(model, std=0.05, generator=g).to(device)


def _rays(R, S, device, seed=1):
    g = torch.Generator().manual_seed(seed)
    ro = 0.1 * torch.randn(R, 3, generator=g)
    rd = 0.2 * torch.randn(R, 3, generator=g) + torch.tensor([0, 0, -1.0])
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    z, _ = torch.sort(2 + 4 * torch.rand(R, S, generator=g), dim=-1)
    return [t.to(device) for t in (ro, rd, vd, z)]


@pytest.mark.cuda
def test_cuda_build_and_packed_layout(cuda_device):
    assert _build.lib().nnc_params_size() == mlp_fused.PARAMS_SIZE


@pytest.mark.cuda
def test_cuda_mlp_from_points_matches_plain(cuda_device):
    model = _fog_model(cuda_device)
    g = torch.Generator().manual_seed(2)
    n = 10_000  # not a tile multiple
    pts = (2 * torch.randn(n, 3, generator=g)).to(cuda_device)
    vd = torch.randn(n, 3, generator=g).to(cuda_device)
    packed = mlp_fused.pack_weights(model)
    before = _build.launch_counts()["mlp_from_points"]
    got = mlp_fused.mlp_from_points(packed, pts, vd)
    torch.cuda.synchronize()
    assert _build.launch_counts()["mlp_from_points"] == before + 1
    want = mlp_fused.fused_nerf_mlp_from_points_plain(packed, pts, vd)
    assert float((got - want).abs().max()) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("eps,want_weights", [(0.0, True), (1e-4, True),
                                              (1e-4, False)])
def test_cuda_render_pass_matches_plain(cuda_device, eps, want_weights):
    model = synthetic.make_solid_mlp(noise_std=1e-2, device=cuda_device,
                                     generator=torch.Generator()
                                     .manual_seed(3))
    R, S = 333, 80  # ragged ray tile and sample block
    ro, rd, vd, z = _rays(R, S, cuda_device)
    ro = ro + torch.tensor([0.0, 0.0, 4.0], device=cuda_device)
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)],
                      -1) * torch.linalg.norm(rd, dim=-1, keepdim=True)
    live = (torch.arange(R, device=cuda_device) % 128 < 64).to(torch.int32)
    term = -math.log(eps) if eps > 0 else math.inf
    packed = mlp_fused.pack_weights(model)
    args = (packed, ro, rd, vd, z, dists, live, term, want_weights)
    maps, w = render_fused.render_pass(*args)
    torch.cuda.synchronize()
    maps_p, w_p = render_fused.fused_render_pass_plain(*args)
    tol = 1e-4 if eps == 0 else 2 * eps
    assert float((maps[:, :4] - maps_p[:, :4]).abs().max()) <= tol
    assert float((maps[:, 4] - maps_p[:, 4]).abs().max()) <= 10 * tol
    assert float(maps[live == 0].abs().max()) == 0.0
    assert float(maps[:, 3].max()) > 0.5  # rays reach the solid
    if want_weights:
        assert float((w - w_p).abs().max()) <= tol
    else:
        assert w is None


@pytest.mark.cuda
def test_cuda_renderer_kernels_vs_plain_path(cuda_device):
    """render_rays through K-B2 (culling + early termination) against the
    plain path (apply_mlp + raw2outputs): the bound of the reference's own
    culled-vs-exact test; K-B3 for raw_noise_std > 0."""
    model_c = synthetic.make_solid_mlp(noise_std=1e-2, device=cuda_device,
                                       generator=torch.Generator()
                                       .manual_seed(4))
    model_f = synthetic.make_solid_mlp(noise_std=1e-2, device=cuda_device,
                                       generator=torch.Generator()
                                       .manual_seed(5))
    R = 1000
    ro, rd, vd, _ = _rays(R, 1, cuda_device)
    ro = ro + torch.tensor([0.0, 0.0, 4.0], device=cuda_device)
    rd[::4] = -rd[::4]  # some rays miss the solid
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    plain = renderer.RenderConfig(n_samples=64, n_importance=128,
                                  perturb=False, white_bkgd=True)
    fused = renderer.RenderConfig(n_samples=64, n_importance=128,
                                  perturb=False, white_bkgd=True,
                                  use_fused_mlp=True,
                                  use_fused_compositing=True)
    _build.reset_launch_counts()
    with torch.no_grad():
        want = renderer.render_rays(model_c, model_f, ro, rd, vd, 2.0, 6.0,
                                    plain, deterministic=True)
        assert _build.launch_counts() == {"render_pass": 0,
                                          "mlp_from_points": 0}
        got = renderer.render_rays(model_c, model_f, ro, rd, vd, 2.0, 6.0,
                                   fused, deterministic=True)
        assert _build.launch_counts()["render_pass"] == 2
        for k in ("rgb_map", "rgb0"):
            assert float((got[k] - want[k]).abs().max()) < 5e-3, k
        noisy = renderer.RenderConfig(n_samples=64, n_importance=64,
                                      perturb=False, raw_noise_std=1.0,
                                      use_fused_mlp=True,
                                      use_fused_compositing=True)
        got_n = renderer.render_rays(model_c, model_f, ro, rd, vd, 2.0, 6.0,
                                     noisy, deterministic=True)
        assert _build.launch_counts()["mlp_from_points"] == 2
        want_n = renderer.render_rays(
            model_c, model_f, ro, rd, vd, 2.0, 6.0,
            renderer.RenderConfig(n_samples=64, n_importance=64,
                                  perturb=False, raw_noise_std=1.0),
            deterministic=True)
        # the coarse pass is the kernel alone; the fine one also carries
        # sample_pdf's jumps on last-bit weight changes
        assert float((got_n["rgb0"] - want_n["rgb0"]).abs().max()) < 1e-4
        assert float((got_n["rgb_map"] - want_n["rgb_map"]).abs().max()) \
            < 5e-3
