"""K-B1's IPE instantiation (mip-NeRF) on the card, against its plain
PyTorch versions and its plain model of the 3xTF32 arithmetic. Every test
needs a CUDA device and skips without one. No JAX here: run it on the card
without the repository's conftest, beside tests/test_torch_port_cuda.py:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_mipnerf_cuda.py

Bars, float32 on both sides, as the vanilla instantiation's card tests
(tests/test_torch_port_cuda.py) hold K-B1: raw within 3e-5 of the plain
version (K-B3's TOL; the products are 3xTF32); dls and db by the gradient
criterion (99.9% of the elements within rtol 5e-2 / atol 5e-3 of the
gradient's largest, none off by more than 5% of it: sums over every point
in another order, through relu masks that may flip at ties). Reruns are
bit-equal (no atomics). The sizes: 32,768 points, a tenth of a step's
level; 196,608, the vanilla lego step's fine pass; 1,048,576, a mip-NeRF
step's two levels of 4,096 rays x 128 samples at once.
"""
import ctypes
import dataclasses
import math

import pytest
import torch

from nnc_tpu_torch.data import synthetic
from nnc_tpu_torch.models import nerf
from nnc_tpu_torch.ops import _build, mlp_train_fused as M
from nnc_tpu_torch.render import mipnerf


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build with nvcc for "
                    "sm_90a and run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _mip_model(device, seed=0):
    g = torch.Generator().manual_seed(seed)
    model = synthetic._activate(nerf.init_params(nerf.MIPNERF, g), g)
    return nerf.init_lsa_scales(model, std=0.05, generator=g).to(device)


def _frusta(n, device, seed=1):
    """n frusta of rays from a sphere of radius 4 towards the origin, 128
    a ray between 2 and 6, at lego's pixel radius: (pts (n, 6), vd)."""
    g = torch.Generator().manual_seed(seed)
    rays = -(-n // 128)
    ro = torch.randn(rays, 3, generator=g)
    ro = 4 * ro / torch.linalg.norm(ro, dim=-1, keepdim=True)
    rd = -ro / 4 + 0.2 * torch.randn(rays, 3, generator=g)
    t = mipnerf.stratified(2.0, 6.0, 129, rays,
                           torch.rand(rays, 129, generator=g), "cpu")
    means, covs = mipnerf.cast(t, ro, rd, 2 / (math.sqrt(12) * 1111.111))
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    pts = torch.cat([means, covs], -1).reshape(-1, 6)[:n]
    vd = vd[:, None, :].expand(rays, 128, 3).reshape(-1, 3)[:n]
    return pts.contiguous().to(device), vd.contiguous().to(device)


def _grads_close(got, want, what):
    scale = max(float(want.abs().max()), 1e-12)
    close = torch.isclose(got, want, rtol=5e-2, atol=5e-3 * scale)
    assert float(close.float().mean()) > 0.999, (what, close.float().mean())
    assert float((got - want).abs().max()) < 0.05 * scale, what


@pytest.mark.cuda
def test_cuda_ipe_buffer_sizes(cuda_device):
    """The IPE forward's buffer: 149 slabs and the heads, as the kernel
    reads it; the backward's is the vanilla one's length."""
    size = ctypes.c_int()
    _build.lib().nnc_train_wgmma_ipe_size(ctypes.byref(size))
    assert size.value == M.IPE.fwd_size == 149 * M.WG_SLAB + 640
    assert M.IPE.bwd_index.size == M.BWD_WG_SIZE


@pytest.mark.cuda
@pytest.mark.parametrize("n", [32_768, 196_608, 1_048_576, 16_401])
def test_cuda_ipe_train_matches_plain(cuda_device, n):
    """The IPE forward (with and without the workspace) and the backward
    without dW against the exact plain versions and the 3xTF32 models, and
    bit-equal reruns; 16,401 ends in a ragged tile."""
    model = _mip_model(cuda_device)
    pts, vd = _frusta(n, cuda_device)
    g = torch.Generator().manual_seed(6)
    cot = (1e-2 * torch.randn(n, 4, generator=g)).to(cuda_device)
    tensors = M._layer_tensors(model)
    params, params_t, ls = M.pack_train(tensors[0::3], tensors[1::3],
                                        tensors[2::3])
    before = _build.launch_counts()
    raw, ws = M.mlp_train_fwd(params, ls, pts, vd, save_u=True)
    flat = M.mlp_train_bwd(params, params_t, ls, pts, vd, cot, ws, False)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert after["mlp_train_fwd_ipe"] == before["mlp_train_fwd_ipe"] + 1
    assert after["mlp_train_bwd_ipe"] == before["mlp_train_bwd_ipe"] + 1
    assert after["mlp_train_fwd"] == before["mlp_train_fwd"]
    assert ws.shape == (-(-n // 64) * 64, M.U_SIZE)
    assert torch.isfinite(ws).all() and torch.isfinite(flat).all()
    raw_p = M.mlp_train_fwd_plain(params, ls, pts, vd)
    raw_3 = M.mlp_train_fwd_3xtf32_plain(params, ls, pts, vd)
    assert float((raw - raw_p).abs().max()) <= 3e-5
    assert float((raw - raw_3).abs().max()) <= 3e-5
    raw0, none = M.mlp_train_fwd(params, ls, pts, vd)
    assert none is None and torch.equal(raw0, raw)
    for plain in (M.mlp_train_bwd_plain(params, params_t, ls, pts, vd, cot,
                                        False),
                  M.mlp_train_bwd_3xtf32_plain(params, params_t, ls, pts, vd,
                                               cot)):
        for part, got, want in zip(("dls", "db"),
                                   M.split_grads(flat, False)[1:],
                                   M.split_grads(plain, False)[1:]):
            for name in got:
                _grads_close(got[name], want[name], f"{part} {name}")
    packed, packed_t = M.pack_train_wgmma(tensors[0::3])
    biases = M.gather_biases(params)
    raw_c, ws_c = M.mlp_train_fwd(None, ls, pts, vd, save_u=True,
                                  packed_wg=packed, biases=biases)
    again = M.mlp_train_bwd(None, None, ls, pts, vd, cot, ws_c, False,
                            packed_wg_t=packed_t, biases=biases)
    assert torch.equal(raw_c, raw) and torch.equal(ws_c, ws)
    assert torch.equal(again, flat)


@pytest.mark.cuda
def test_cuda_ipe_autograd_and_test_view(cuda_device):
    """fused_ipe_mlp_train's scale and bias gradients against autograd of
    the plain MLP, and a deterministic test view through the IPE forward
    without its workspace against the plain render (raw within 3e-5, so
    the maps within 1e-4)."""
    model = _mip_model(cuda_device, seed=3)
    rc = mipnerf.MipRenderConfig(chunk=1024)
    g = torch.Generator().manual_seed(4)
    R = 2048
    ro = torch.randn(R, 3, generator=g)
    ro = (4 * ro / torch.linalg.norm(ro, dim=-1, keepdim=True))
    rd = -ro / 4 + 0.1 * torch.randn(R, 3, generator=g)
    ro, rd = ro.to(cuda_device), rd.to(cuda_device)
    tgt = torch.rand(R, 3, generator=g).to(cuda_device)
    draws = {k: torch.rand(R, 129, generator=g).to(cuda_device)
             for k in ("t_rand", "u")}
    grads = []
    for fused in (True, False):
        for layer in model.layers().values():
            layer.weight.requires_grad_(False)
            layer.weight_scaling.requires_grad_(True)
            layer.weight_scaling.grad = None
        loss, _ = mipnerf.mip_loss(model, None, ro, rd, None, tgt, 2.0, 6.0,
                                   mipnerf.MipRenderConfig(
                                       use_fused_train=fused), draws=draws)
        loss.backward()
        grads.append({n: layer.weight_scaling.grad.clone()
                      for n, layer in model.layers().items()})
    for name in grads[0]:
        _grads_close(grads[0][name], grads[1][name], name)
    for layer in model.layers().values():
        layer.weight_scaling.requires_grad_(False)
    got = mipnerf.render_image(model, ro, rd, 2.0, 6.0, rc)
    want = mipnerf.render_image(model, ro, rd, 2.0, 6.0,
                                mipnerf.MipRenderConfig(
                                    chunk=1024, use_fused_train=False))
    assert float((got["rgb_map"] - want["rgb_map"]).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_cuda_ipe_refuses_a_bf16_mip_model(cuda_device):
    """The IPE instantiation has no bf16 form: a bf16 mip-NeRF model on
    the card is refused with a clear error, in training and in test views,
    where the plain MLP would otherwise run in its place unnoticed."""
    g = torch.Generator().manual_seed(7)
    cfg = dataclasses.replace(nerf.MIPNERF, compute_dtype=torch.bfloat16)
    model = nerf.init_lsa_scales(nerf.init_params(cfg, g)).to(cuda_device)
    pts, vd = _frusta(256, cuda_device)
    means, covs = pts[:, :3], pts[:, 3:]
    for fn in (M.fused_ipe_mlp_train, M.ipe_mlp_forward):
        with pytest.raises(ValueError, match="float32 only"):
            fn(model, means, covs, vd)
