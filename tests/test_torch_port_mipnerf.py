"""mip-NeRF on the port (``render/mipnerf.py``, K-B1's IPE stage in
``ops/mlp_train_fused.py``, ``models.nerf.from_mipnerf_params``, LSA's
one-network form and ``compress_model``) against the plain reference
``tests/mipnerf_reference.py`` on the CPU, at a small size (a few rays, 8
samples a level; the MLP at its published widths), on seeded random
weights: a flax tree in mip-NeRF's own order, which the port loads.

Tolerances, float32 on both sides, and why:
  * casting, IPE, stratified sampling and the resample: the same float32
    operations in the same order (the resample finds its intervals by a
    binary search where the reference masks, the same interval of sorted
    CDFs): equal to 1e-6 (t in [2, 6]: a few ulp; a fused multiply-add
    may round once less);
  * the published radii measure float32 differences of directions 1 / f
    apart, ~1e-3, of unit vectors: 1e-4 relative to the port's 2 / (sqrt(12)
    f);
  * raw outputs of the MLP, port (its channels permuted, so other orders
    of the float32 sums) against the reference: 1e-5; the plain model of
    the tensor cores' 3xTF32 arithmetic: 3e-5 (the card's bar, tests/
    test_torch_port_cuda.py);
  * a training step's loss, relative: 1e-6; each scale's gradient, as the
    gap of its norm relative to its norm: 2e-5 (reassociated sums over the
    rays' points; measured 8e-8 and 4.9e-7). The TF32 control (every
    product's operands rounded to TF32) moves them by 4.5e-6 and 1.7e-3 and
    fails both;
  * the render of a view: 1e-5 (composited sums of raw outputs within 1e-5
    in a value range of ~1).
"""
import math
import os

import numpy as np
import pytest
import torch

import mipnerf_reference as ref
from nnc_tpu_torch.data.rays import RayBatcher
from nnc_tpu_torch.models import nerf
from nnc_tpu_torch.ops import mlp_train_fused as M
from nnc_tpu_torch.ops.posenc import (integrated_positional_encoding,
                                      positional_encoding)
from nnc_tpu_torch.render import mipnerf
from nnc_tpu_torch.train import lsa
from nnc_tpu_torch.utils import profiling

FOCAL = 1111.1110311937682       # lego at 800 x 800
RADIUS = 2 / (math.sqrt(12) * FOCAL)
S = 8                             # samples a level in these tests
NEAR, FAR = 2.0, 6.0


def _tree(seed=0):
    """A random mip-NeRF MLP as its flax tree (kernels (in, out)), with
    visible density and colour: U(-1/sqrt(in), 1/sqrt(in)), the density
    head x40 and +0.5, the rgb head x20 (the port's random-teacher
    recipe)."""
    g = torch.Generator().manual_seed(seed)
    dims = [96, 256, 256, 256, 256, 352, 256, 256, 256, 256, 283, 128]
    outs = [256] * 8 + [1, 256, 128, 3]
    tree = {}
    for i, (din, dout) in enumerate(zip(dims, outs)):
        b = 1 / math.sqrt(din)
        tree[f"Dense_{i}"] = {
            "kernel": (torch.rand(din, dout, generator=g) * 2 - 1) * b,
            "bias": (torch.rand(dout, generator=g) * 2 - 1) * b}
    tree["Dense_8"]["kernel"] *= 40
    tree["Dense_8"]["bias"] += 0.5
    tree["Dense_11"]["kernel"] *= 20
    return tree


def _rays(R=12, seed=1):
    g = torch.Generator().manual_seed(seed)
    ro = torch.randn(R, 3, generator=g)
    ro = 4 * ro / torch.linalg.norm(ro, dim=-1, keepdim=True)
    rd = -ro / 4 + 0.1 * torch.randn(R, 3, generator=g)
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    return ro, rd, vd


def _draws(R, seed=2):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.rand(R, S + 1, generator=g) for k in ("t_rand", "u")}


def _rc(**kw):
    return mipnerf.MipRenderConfig(**{"num_samples": S,
                                      "pixel_radius": RADIUS, **kw})


def _ref_rays(ro, rd, vd):
    return ro, rd, vd, torch.full((ro.shape[0], 1), RADIUS)


def test_cone_casting_and_ipe():
    ro, rd, _vd = _rays()
    t = mipnerf.stratified(NEAR, FAR, S + 1, ro.shape[0],
                           _draws(12)["t_rand"], "cpu")
    t_ref, (m_ref, c_ref) = ref.sample_along_rays(
        ro, rd, torch.full((12, 1), RADIUS), S, NEAR, FAR,
        _draws(12)["t_rand"])
    torch.testing.assert_close(t, t_ref, rtol=0, atol=1e-6)
    means, covs = mipnerf.cast(t, ro, rd, RADIUS)
    torch.testing.assert_close(means, m_ref, rtol=0, atol=1e-6)
    torch.testing.assert_close(covs, c_ref, rtol=1e-6, atol=0)
    enc = integrated_positional_encoding(means, covs)
    want = ref.integrated_pos_enc(m_ref, c_ref)
    assert enc.shape == want.shape == (12, S, 96)
    torch.testing.assert_close(enc, want[..., nerf.IPE_FROM_MIP], rtol=0,
                               atol=1e-6)
    # the view encoding: the port's posenc against mip-NeRF's, permuted
    v = torch.randn(5, 3)
    torch.testing.assert_close(positional_encoding(v, 4),
                               ref.pos_enc(v)[..., nerf.VIEWS_FROM_MIP],
                               rtol=0, atol=1e-6)
    # far frequencies: the argument reduced as safe_sin reduces it
    big = torch.tensor([[400.0, -1234.5, 3e4]])
    torch.testing.assert_close(
        integrated_positional_encoding(big, torch.zeros_like(big)),
        ref.integrated_pos_enc(big, torch.zeros_like(big))[
            ..., nerf.IPE_FROM_MIP], rtol=0, atol=1e-6)


def test_pixel_radius_is_the_published_one():
    from nnc_tpu_torch.render.rays import get_rays_np
    from nnc_tpu_torch.train.presets import _intrinsics, pixel_centres
    K = pixel_centres(_intrinsics(32, 32, FOCAL / 25))
    c2w = np.eye(4)[:3]
    c2w[:, :3] = np.linalg.qr(np.random.default_rng(0).normal(size=(3, 3)))[0]
    _o, d = get_rays_np(32, 32, K, c2w)
    radii = ref.pixel_radii(torch.as_tensor(d))
    want = 2 / (math.sqrt(12) * FOCAL / 25)
    torch.testing.assert_close(radii, torch.full_like(radii, want),
                               rtol=1e-4, atol=0)
    # the pixels' centres: the middle pixel's ray leaves half a pixel off
    _o, d0 = get_rays_np(32, 32, K, np.eye(4)[:3])
    assert d0[16, 16, 0] == pytest.approx(0.5 / (FOCAL / 25), rel=1e-5)


@pytest.mark.parametrize("given_u", [True, False],
                         ids=["randomized", "deterministic"])
def test_resample_from_given_u(given_u):
    g = torch.Generator().manual_seed(3)
    R = 20
    t = mipnerf.stratified(NEAR, FAR, S + 1, R,
                           torch.rand(R, S + 1, generator=g), "cpu")
    w = torch.rand(R, S, generator=g) ** 4
    w[0] = 0.0          # a ray of no weight: the padding alone
    w[1, :] = 0.0
    w[1, 3] = 1.0       # a spike
    u = torch.rand(R, S + 1, generator=g) if given_u else None
    got = mipnerf.resample(t, w, u)
    ro, rd, _vd = _rays(R)
    want, _ = ref.resample_along_rays(ro, rd, torch.full((R, 1), RADIUS), t,
                                      w, u)
    assert got.shape == (R, S + 1)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    assert bool((got[:, 1:] >= got[:, :-1]).all())


def _port_model(tree, scales=True):
    model = nerf.from_mipnerf_params(tree)
    return nerf.init_lsa_scales(model) if scales else model


def _port_step(model, ro, rd, vd, tgt, draws, rc):
    trained = lsa.trained_tensors(model, None)
    loss, _fine = mipnerf.mip_loss(model, None, ro, rd, vd, tgt, NEAR, FAR,
                                   rc, draws=draws)
    grads = torch.autograd.grad(loss, trained)
    return float(loss.detach()), {n: float(torch.linalg.norm(g))
                                  for n, g in zip(model.layers(), grads)}


def _ref_step(tree, ro, rd, vd, tgt, draws, tf32=False):
    leaves = {k: torch.ones(v["kernel"].shape[1], requires_grad=True)
              for k, v in tree.items()}
    with ref.fp32_matmul():
        loss, _fine = ref.loss(tree, _ref_rays(ro, rd, vd), tgt, NEAR, FAR,
                               draws, leaves, tf32, num_samples=S)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    return float(loss.detach()), {nerf.MIP_DENSE[k]: float(torch.linalg.norm(g))
                                  for k, g in zip(leaves, grads)}


def _gaps(got, want):
    loss_gap = abs(got[0] - want[0]) / abs(want[0])
    grad_gap = max(abs(got[1][n] - want[1][n]) / want[1][n]
                   for n in want[1])
    return loss_gap, grad_gap


def test_two_level_step_loss_and_every_scale_gradient():
    tree = _tree()
    ro, rd, vd = _rays()
    tgt = torch.rand(12, 3, generator=torch.Generator().manual_seed(5))
    draws = _draws(12)
    want = _ref_step(tree, ro, rd, vd, tgt, draws)
    got = _port_step(_port_model(tree), ro, rd, vd, tgt, draws, _rc())
    assert len(got[1]) == 12 and all(v > 0 for v in want[1].values())
    loss_gap, grad_gap = _gaps(got, want)
    assert loss_gap <= 1e-6 and grad_gap <= 2e-5, (loss_gap, grad_gap)
    # the plain MLP (use_fused_train off) gives the same step
    plain = _port_step(_port_model(tree), ro, rd, vd, tgt, draws,
                       _rc(use_fused_train=False))
    p_loss, p_grad = _gaps(plain, want)
    assert p_loss <= 1e-6 and p_grad <= 2e-5, (p_loss, p_grad)
    # the TF32 control fails both bars
    ctl = _ref_step(tree, ro, rd, vd, tgt, draws, tf32=True)
    c_loss, c_grad = _gaps(ctl, want)
    assert c_loss > 1e-6 and c_grad > 2e-5, (c_loss, c_grad)


def test_ipe_3xtf32_model_and_plain_against_the_reference():
    tree = _tree(seed=4)
    model = _port_model(tree)
    g = torch.Generator().manual_seed(7)
    ro, rd, vd = _rays(40, seed=8)
    t = mipnerf.stratified(NEAR, FAR, S + 1, 40,
                           torch.rand(40, S + 1, generator=g), "cpu")
    means, covs = mipnerf.cast(t, ro, rd, RADIUS)
    pts = torch.cat([means, covs], -1).reshape(-1, 6)
    vds = vd[:, None].expand(40, S, 3).reshape(-1, 3).contiguous()
    tensors = M._layer_tensors(model)
    params, params_t, ls = M.pack_train(tensors[0::3], tensors[1::3],
                                        tensors[2::3])
    with ref.fp32_matmul():
        rgb, dens = ref.mlp(tree, ref.integrated_pos_enc(
            means, covs).reshape(-1, 96), ref.pos_enc(vds))
    want = torch.cat([rgb, dens], -1)
    exact = M.mlp_train_fwd_plain(params, ls, pts, vds)
    model3 = M.mlp_train_fwd_3xtf32_plain(params, ls, pts, vds)
    assert float((exact - want).abs().max()) <= 1e-5
    assert float((model3 - want).abs().max()) <= 3e-5
    # the TF32 control fails the 3xTF32 bar
    with ref.fp32_matmul():
        rgb, dens = ref.mlp(tree, ref.integrated_pos_enc(
            means, covs).reshape(-1, 96), ref.pos_enc(vds), tf32=True)
    assert float((torch.cat([rgb, dens], -1) - want).abs().max()) > 3e-5
    # the backward's plain versions agree with autograd of the reference's
    # scales (cotangent g on raw)
    cot = 1e-2 * torch.randn(pts.shape[0], 4, generator=g)
    flat = M.mlp_train_bwd_3xtf32_plain(params, params_t, ls, pts, vds, cot)
    leaves = {k: torch.ones(v["kernel"].shape[1], requires_grad=True)
              for k, v in tree.items()}
    with ref.fp32_matmul():
        rgb, dens = ref.mlp(tree, ref.integrated_pos_enc(
            means, covs).reshape(-1, 96), ref.pos_enc(vds), leaves)
        grads = torch.autograd.grad((torch.cat([rgb, dens], -1) * cot).sum(),
                                    list(leaves.values()))
    _dw, dls, _db = M.split_grads(flat, False)
    for k, gr in zip(leaves, grads):
        name = nerf.MIP_DENSE[k]
        assert float(torch.linalg.norm(dls[name] - gr)) <= \
            1e-4 * float(torch.linalg.norm(gr)), name


def test_flax_loader_renders_the_reference_view():
    tree = _tree(seed=9)
    model = _port_model(tree, scales=False)
    ro, rd, vd = _rays(30, seed=10)
    rgb_ref, acc_ref = ref.render_blocks(tree, _ref_rays(ro, rd, vd), NEAR,
                                         FAR, num_samples=S)
    out = mipnerf.render_image(model, ro, rd, NEAR, FAR, _rc(chunk=7))
    assert float(acc_ref.min()) > 0.05       # the view sees density
    torch.testing.assert_close(out["rgb_map"], rgb_ref, rtol=0, atol=1e-5)
    torch.testing.assert_close(out["acc_map"], acc_ref, rtol=0, atol=1e-5)
    # the loader's rows: the skip layer's inputs and the view layer's
    w5 = model.pts_linears[5].weight
    k5 = tree["Dense_5"]["kernel"]
    torch.testing.assert_close(w5[:, 96:], k5[:256].t())
    torch.testing.assert_close(w5[:, :96], k5[256:][nerf.IPE_FROM_MIP].t())


def _batcher(n_views=2, hw=8, n_rand=16, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.random((n_views, hw, hw, 3)).astype(np.float32)
    poses = np.stack([np.eye(4)[:3] for _ in range(n_views)]).astype(
        np.float32)
    poses[:, 2, 3] = 4.0
    poses[1, 0, 3] = 0.3
    K = np.array([[hw * 1.2, 0, hw / 2 - 0.5], [0, hw * 1.2, hw / 2 - 0.5],
                  [0, 0, 1]], np.float32)
    return RayBatcher(images, poses, K, np.arange(n_views), n_rand,
                      seed=seed)


@pytest.mark.parametrize("k", [8, 3])
def test_tune_lsa_scales_calls_of_k_equal_single_steps(k):
    """One network's scales, trained once a step on both levels' summed
    gradients: calls of k steps give single steps' trajectory bit for bit;
    the calls' spans count MLP points over both levels."""
    tree = _tree(seed=11)
    rc = _rc(pixel_radius=2 / (math.sqrt(12) * 9.6))
    out = []
    for spc in (k, 1):
        model = _port_model(tree)
        stats = {}
        with profiling.trace_if(None, enabled=spc == k):
            ls, ls_f, _psnr, _loss, step, _b = lsa.tune_lsa_scales(
                model, None, _batcher(), rc, NEAR, FAR, n_iters=9, epochs=1,
                learning_rate=1e-3, learning_rate_decay=0.0, verbose=False,
                steps_per_call=spc, seed=5, stats=stats)
        assert ls_f == {} and step == 9
        out.append(ls)
        if spc == k:
            calls = [s for s in profiling.spans() if s.name == "nnc.lsa.call"]
            assert calls and all(c.counts["points"] ==
                                 c.counts["steps"] * 16 * 2 * S
                                 for c in calls[-len(stats["calls"]):])
            names = {s.name for s in profiling.spans()}
            assert {"nnc.mip.cast", "nnc.mip.resample",
                    "nnc.mip.composite"} <= names
    for name in out[0]:
        assert torch.equal(out[0][name], out[1][name]), name
    assert any(float((v - 1).abs().max()) > 0 for v in out[0].values())


def test_mip_refuses_what_it_does_not_run():
    """Another encoding or level count than the published, a fine network,
    an occupancy grid."""
    scene = {"K": np.eye(3) * 100.0, "mip": {"max_deg_point": 10}}
    with pytest.raises(ValueError, match="published"):
        mipnerf.make_render_config(scene)
    rc = mipnerf.make_render_config(
        {"K": np.eye(3) * 100.0, "mip": {"num_samples": 8, "deg_view": 4}})
    assert rc.num_samples == 8 and rc.pixel_radius == pytest.approx(
        2 / (math.sqrt(12) * 100.0))
    model = _port_model(_tree())
    for other, grid in ((model, None), (None, object())):
        with pytest.raises(ValueError, match="one network"):
            lsa.tune_lsa_scales(model, other, _batcher(), _rc(), NEAR, FAR,
                                n_iters=1, verbose=False, grid=grid)


def test_compress_model_lsa_end_to_end(tmp_path):
    """A mip-NeRF checkpoint (one MLP, ``model.*``) of a Blender tree
    through compress_model(lsa=True): the scene from a config file with
    ``model = mipnerf``, LSA on the two-level loss through the IPE stage's
    plain versions, test views and the decode."""
    import nnc_tpu_torch
    from test_data_loaders import make_blender_tree
    from nnc_tpu_torch.train.presets import load_scene_from_config
    data = tmp_path / "blender"
    data.mkdir()
    make_blender_tree(str(data), n=2, size=8)
    cfg = tmp_path / "mip.txt"
    text = open(os.path.join(os.path.dirname(nnc_tpu_torch.__file__),
                             "configs", "mip_lego.txt")).read()
    cfg.write_text(text.replace("num_samples = 128", f"num_samples = {S}")
                   + "\ntestskip = 1\n")
    scene, extra = load_scene_from_config(str(cfg), str(data))
    assert scene["mip"]["num_samples"] == S and extra["n_rand"] == 4096
    assert scene["K"][0][2] == 3.5 and scene["near"] == 2.0
    model = _port_model(_tree(seed=12), scales=False)
    params = nerf.params_to_state_dict(model, "model.")
    bitstream = str(tmp_path / "run" / "bitstream" / "b.nnc")
    os.makedirs(os.path.dirname(bitstream))
    with pytest.raises(ValueError, match="occupancy"):
        nnc_tpu_torch.compress_model(
            params, bitstream_path=bitstream, qp=-20, lsa=True, scene=scene,
            device="cpu", verbose=False, occupancy_tuning=True)
    nnc_tpu_torch.compress_model(
        params, bitstream_path=bitstream, qp=-20, lsa=True, scene=scene,
        N_iters=2, epochs=1, i_save=2, N_rand=16, device="cpu",
        verbose=False)
    rec = nnc_tpu_torch.decompress_model(bitstream, verbose=False)
    assert set(rec) == set(params)
    ck = torch.load(str(tmp_path / "run" / "reconstructed" /
                        "ckpt_step2.pt"), weights_only=True)
    assert "model.pts_linears.0.weight_scaling" in ck
    assert not any(k.startswith("model_fine.") for k in ck)
    assert os.path.isdir(str(tmp_path / "run" / "testset_step2"))
