"""mip-NeRF 360 on the port (``render/mipnerf360.py``, ``models/
mipnerf360.py``, K-B7's wrapper ``ops/lsa_epilogue.py``, ``lsa.route``'s
third family, the executer, the config file and the CLI) against the plain
reference ``benchmark/reference/mipnerf360.py`` on the CPU, at a small size:
MLP widths 32 (NeRF) and 16 (proposal), bottleneck 16, view layer 8, 8 + 8
+ 4 samples, encoding degrees 0..2 over the 21 basis directions, on seeded
random weights in multinerf's flax layout.

Tolerances, float32 on both sides, and why:
  * K-B7's autograd function against plain autograd of the same layer:
    1e-6 relative (the same float32 products; only the scale gradient's
    sum runs in another order);
  * J cov J^T against ``torch.autograd.functional.jacobian`` in float64:
    1e-5 relative to the covariance's norm (float32 casts of a float64
    product, at |x| up to 8);
  * the dilated step function against its brute-force evaluation: 1e-6
    (the same comparisons; the sums of a renormalisation);
  * a training step's loss against the reference, relative: 2e-6; each
    scale's gradient, the gap of its norm relative to its norm: 1e-4 (the
    proposal's gradient comes through the interlevel loss's clamps and the
    NeRF level's through the inverse CDF's interpolation, summed in other
    orders: the basis projection as element-wise sums where the reference
    multiplies matrices, the skip layer as two products); the TF32 control
    fails the gradient bar.
"""
import math
import os

import numpy as np
import pytest
import torch

from benchmark.reference import mipnerf360 as ref
from nnc_tpu_torch.models import mipnerf360 as m360
from nnc_tpu_torch.ops import lsa_epilogue
from nnc_tpu_torch.render import mipnerf360
from nnc_tpu_torch.train import lsa

FOCAL = 100.0
NEAR, FAR = 0.2, 1e6
SIZES = ref.Sizes(prop_depth=4, prop_width=16, nerf_depth=8, nerf_width=32,
                  bottleneck=16, view_width=8, num_prop_samples=8,
                  num_nerf_samples=4, max_deg_point=3)
ENC = 2 * 21 * 3
PROP = m360.MLP360Config(depth=4, width=16, input_ch=ENC)
NERF = m360.MLP360Config(depth=8, width=32, input_ch=ENC, rgb=True,
                         bottleneck=16, view_width=8)


def _rc():
    return mipnerf360.Mip360RenderConfig(
        prop=PROP, nerf=NERF, num_prop_samples=8, num_nerf_samples=4,
        max_deg_point=3, pixel_radius=2 / (math.sqrt(12) * FOCAL))


def _tree(seed=0):
    """Both MLPs as multinerf's flax tree, U(-1/sqrt(in), 1/sqrt(in)), the
    density layers x20 (visible density), the rgb layer x10."""
    g = torch.Generator().manual_seed(seed)
    tree = {}
    for key, cfg in (("prop_mlp", PROP), ("nerf_mlp", NERF)):
        dims = list(m360.layer_dims(cfg).values())
        tree[key] = {}
        for i, (d_in, d_out) in enumerate(dims):
            b = 1 / math.sqrt(d_in)
            tree[key][f"Dense_{i}"] = {
                "kernel": (torch.rand(d_in, d_out, generator=g) * 2 - 1) * b,
                "bias": (torch.rand(d_out, generator=g) * 2 - 1) * b}
        tree[key][f"Dense_{cfg.depth}"]["kernel"].mul_(20.0)
        if cfg.rgb:
            tree[key][f"Dense_{cfg.depth + 3}"]["kernel"].mul_(10.0)
    return tree


def _rays(R=24, seed=1):
    g = torch.Generator().manual_seed(seed)
    ro = (torch.rand(R, 3, generator=g) * 2 - 1) * 0.5
    rd = torch.randn(R, 3, generator=g)
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    tgt = torch.rand(R, 3, generator=g)
    jitter = torch.rand(R, 3, generator=g)
    return ro, rd, vd, tgt, jitter


def _port_models(tree):
    prop, nerf = m360.from_mipnerf360_params(tree, prop=PROP, nerf=NERF)
    lsa.trained_tensors(prop, nerf)
    return prop, nerf


def _port_step(tree, ro, rd, vd, tgt, jitter):
    prop, nerf = _port_models(tree)
    route = lsa.route(_rc())
    loss, mse = route.loss(prop, nerf, ro, rd, vd, tgt, NEAR, FAR, _rc(),
                           draws={"jitter": jitter})
    names = [(key, dense, model.layers()[name])
             for key, model in (("prop_mlp", prop), ("nerf_mlp", nerf))
             for dense, name in m360._dense_names(model.config).items()]
    grads = torch.autograd.grad(loss, [l.weight_scaling for *_k, l in names])
    return float(loss.detach()), {f"{k}.{d}": float(torch.linalg.norm(g))
                         for (k, d, _l), g in zip(names, grads)}


def _ref_step(tree, ro, rd, vd, tgt, jitter, tf32=False):
    radii = torch.full((ro.shape[0], 1), 2 / (math.sqrt(12) * FOCAL))
    out = ref.follow_lsa(tree, [((ro, rd, vd, radii), tgt)],
                         [{"jitter": jitter}], SIZES, lr=0.0, tf32=tf32)
    return out["losses"][0], out["grad1"]


def _gaps(got, want):
    loss_gap = abs(got[0] - want[0]) / abs(want[0])
    grad_gap = max(abs(got[1][n] - want[1][n]) / want[1][n] for n in want[1])
    return loss_gap, grad_gap


def test_route_loss_and_every_scale_gradient_against_the_reference():
    tree = _tree()
    ro, rd, vd, tgt, jitter = _rays()
    want = _ref_step(tree, ro, rd, vd, tgt, jitter)
    got = _port_step(tree, ro, rd, vd, tgt, jitter)
    assert len(got[1]) == 5 + 12 and all(v > 0 for v in want[1].values())
    loss_gap, grad_gap = _gaps(got, want)
    assert loss_gap <= 2e-6 and grad_gap <= 1e-4, (loss_gap, grad_gap)
    ctl = _ref_step(tree, ro, rd, vd, tgt, jitter, tf32=True)
    assert _gaps(ctl, want)[1] > 1e-4
    r = lsa.route(_rc())
    assert (r.points_per_ray, r.networks) == (8 + 8 + 4, 2)


def test_blocks_of_rays_sum_to_the_step():
    """The reference's blocked step (as the benchmark runs it on the card)
    equals the whole batch's."""
    tree = _tree(seed=3)
    ro, rd, vd, tgt, jitter = _rays(R=16, seed=4)
    radii = torch.full((16, 1), 2 / (math.sqrt(12) * FOCAL))
    batch = [((ro, rd, vd, radii), tgt)]
    whole = ref.follow_lsa(tree, batch, [{"jitter": jitter}], SIZES, 1e-3)
    blocks = ref.follow_lsa(tree, batch, [{"jitter": jitter}], SIZES, 1e-3,
                            block_rays=5)
    assert blocks["losses"][0] == pytest.approx(whole["losses"][0], rel=1e-6)
    # reassociated sums: each leaf within 1e-5 of the larger of its norm
    # and the median leaf's (a leaf far below the median cancels)
    med = float(np.median(list(whole["grad1"].values())))
    for k, v in whole["grad1"].items():
        assert abs(blocks["grad1"][k] - v) <= 1e-5 * max(v, med), k


@pytest.mark.parametrize("relu,split", [(True, False), (False, False),
                                        (True, True)])
def test_kb7_layer_against_plain_autograd(relu, split):
    from nnc_tpu_torch.models.nerf import Linear
    g = torch.Generator().manual_seed(7)
    layer = Linear(24, 12)
    with torch.no_grad():
        layer.weight.copy_(torch.randn(12, 24, generator=g))
        layer.bias.copy_(torch.randn(12, generator=g))
    layer.weight_scaling = 1 + 0.1 * torch.randn(12, 1, generator=g)
    layer.weight.requires_grad_(False)
    layer.weight_scaling.requires_grad_(True)
    layer.bias.requires_grad_(True)
    x = torch.randn(40, 24, generator=g, requires_grad=True)
    xs = (x[:, :16], x[:, 16:]) if split else (x,)
    y = lsa_epilogue.scaled_linear(layer, xs, relu=relu)
    cot = torch.randn(40, 12, generator=g)
    got = torch.autograd.grad((y * cot).sum(),
                              [layer.weight_scaling, layer.bias, x])
    z = (x @ layer.weight.t()) * layer.weight_scaling.reshape(-1) + layer.bias
    want_y = torch.relu(z) if relu else z
    want = torch.autograd.grad((want_y * cot).sum(),
                               [layer.weight_scaling, layer.bias, x])
    torch.testing.assert_close(y, want_y, rtol=1e-6, atol=1e-6)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-5)
    chunks, rows = lsa_epilogue.backward_chunks(524288, 1024)
    assert chunks * rows >= 524288 and chunks * 8 <= 1024


def test_kb7_refuses_a_trainable_weight():
    """K-B7 gives the weight no gradient: a weight that requires grad is
    refused while grad is enabled, and runs under no_grad."""
    from nnc_tpu_torch.models.nerf import Linear
    layer = Linear(8, 4)
    x = torch.ones(3, 8)
    assert layer.weight.requires_grad
    with pytest.raises(ValueError, match="must not require grad"):
        lsa_epilogue.scaled_linear(layer, (x,), relu=True)
    with torch.no_grad():
        y = lsa_epilogue.scaled_linear(layer, (x,), relu=True)
    assert torch.equal(y, torch.zeros(3, 4))


def test_contraction_covariance_against_the_jacobian():
    g = torch.Generator().manual_seed(2)
    x = torch.randn(64, 3, generator=g, dtype=torch.float64) * \
        torch.linspace(0.1, 8.0, 64, dtype=torch.float64)[:, None]
    a = torch.randn(64, 3, 3, generator=g, dtype=torch.float64)
    cov = a @ a.transpose(-1, -2) * 0.01
    mean32, cov32 = mipnerf360.contract(x.float(), cov.float())
    for i in range(64):
        J = torch.autograd.functional.jacobian(ref.contract, x[i])
        want = J @ cov[i] @ J.T
        scale = float(torch.linalg.norm(want))
        assert float(torch.linalg.norm(cov32[i].double() - want)) <= \
            1e-5 * scale + 1e-12, i
        torch.testing.assert_close(mean32[i].double(), ref.contract(x[i]),
                                   rtol=1e-6, atol=1e-7)
    # the reference's linearisation agrees too
    _m, cov_ref = ref.track_linearize(x.float(), cov.float())
    torch.testing.assert_close(cov_ref, cov32, rtol=1e-5, atol=1e-9)


def test_max_dilate_weights_against_brute_force():
    g = torch.Generator().manual_seed(3)
    R, K = 6, 10
    t = torch.sort(torch.rand(R, K + 1, generator=g), -1)[0]
    t[:, 0], t[:, -1] = 0.0, 1.0
    w = torch.rand(R, K, generator=g)
    w = w / w.sum(-1, keepdim=True)
    d = 0.03
    td, wd = mipnerf360.max_dilate_weights(t, w, d)
    assert td.shape == (R, 3 * K + 1) and wd.shape == (R, 3 * K)
    p = w / (t[:, 1:] - t[:, :-1])
    t0, t1 = (t - d).tolist(), (t + d).tolist()   # float32 as the port's
    for r in range(R):
        brute = []
        for j in range(3 * K):
            lo, hi = float(td[r, j]), float(td[r, j + 1])
            q = lo   # the pdf is constant on [td_j, td_j+1)
            cover = [float(p[r, i]) for i in range(K)
                     if t0[r][i] <= q < t1[r][i + 1]]
            brute.append((max(cover) if cover else 0.0) * (hi - lo))
        brute = torch.tensor(brute)
        brute = brute / brute.sum()
        torch.testing.assert_close(wd[r], brute, rtol=1e-5, atol=1e-6)
    tr, wr = ref.max_dilate_weights(t, w, d, (0.0, 1.0))
    torch.testing.assert_close(td, tr)
    torch.testing.assert_close(wd, wr)


def test_basis_is_21_unit_directions_without_antipodes():
    b = mipnerf360.BASIS
    assert b.shape == (21, 3)
    np.testing.assert_allclose(np.linalg.norm(b, axis=1), 1.0, atol=1e-12)
    dots = b @ b.T
    np.fill_diagonal(dots, 0.0)
    assert dots.min() > -1 + 1e-6 and dots.max() < 1 - 1e-6
    np.testing.assert_array_equal(b, ref.generate_basis(2))


def test_flax_loader_on_a_synthetic_tree():
    tree = _tree(seed=5)
    prop, nerf = m360.from_mipnerf360_params(tree, prop=PROP, nerf=NERF)
    assert list(prop.layers()) == [f"pts_linears.{i}" for i in range(4)] + \
        ["alpha_linear"]
    assert list(nerf.layers())[8:] == ["alpha_linear", "feature_linear",
                                       "views_linears.0", "rgb_linear"]
    assert nerf.pts_linears[5].weight.shape == (32, 32 + ENC)
    assert nerf.views_linears[0].weight.shape == (8, 16 + 27)
    torch.testing.assert_close(nerf.views_linears[0].weight,
                               tree["nerf_mlp"]["Dense_10"]["kernel"].T)
    torch.testing.assert_close(prop.alpha_linear.bias,
                               tree["prop_mlp"]["Dense_4"]["bias"])
    # the published sizes: 8.68 M weights in the NeRF MLP, 0.33 M
    n = lambda cfg: sum((i + 1) * o for i, o in m360.layer_dims(cfg).values())
    assert abs(n(m360.NERF_MLP) - 8.68e6) < 0.01e6
    assert abs(n(m360.PROP_MLP) - 0.33e6) < 0.01e6


def test_render_view_renders_every_ray_deterministically():
    prop, nerf = _port_models(_tree(seed=6))
    ro, rd, vd, _t, _j = _rays(R=10, seed=8)
    view = lsa.route(_rc()).render_view
    a = view(prop, nerf, ro.numpy(), rd.numpy(), NEAR, FAR, None, "cpu")
    b = mipnerf360.render_image(
        prop, nerf, ro, rd, NEAR, FAR,
        mipnerf360.Mip360RenderConfig(**{**_rc().__dict__, "chunk": 3}))
    assert a.shape == (10, 3) and np.isfinite(a).all()
    np.testing.assert_allclose(a, b["rgb_map"].numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(b["acc_map"].numpy(), 1.0, atol=1e-5)


def test_mip360_refuses_what_it_does_not_run(tmp_path):
    """Another published value, NDC scenes, an occupancy grid, a mesh, one
    network, bf16 and occupancy mode in compress_model."""
    import nnc_tpu_torch
    from nnc_tpu_torch import parallel
    from nnc_tpu_torch.models import nerf as pnerf
    from nnc_tpu_torch.train import presets
    K = np.eye(3) * 100.0
    with pytest.raises(ValueError, match="published"):
        mipnerf360.make_render_config({"K": K,
                                       "mip360": {"max_deg_point": 16}})
    with pytest.raises(ValueError, match="NDC"):
        mipnerf360.make_render_config({"K": K, "ndc": True})
    rc = mipnerf360.make_render_config({"K": K, "mip360": {
        "num_prop_samples": 64, "deg_view": 4}})
    assert rc.pixel_radius == pytest.approx(2 / (math.sqrt(12) * 100.0))
    with pytest.raises(ValueError, match="occupancy grid"):
        lsa.route(_rc(), grid=object())
    prop, nerf = _port_models(_tree())
    with pytest.raises(ValueError, match="mesh"):
        lsa.tune_lsa_scales(prop, None, None, _rc(), NEAR, FAR, n_iters=1,
                            verbose=False)
    mesh = parallel.make_mesh(2, ("data",), devices=["cpu"])
    with pytest.raises(ValueError, match="mesh"):
        lsa.tune_lsa_scales(prop, nerf, None, _rc(), NEAR, FAR, n_iters=1,
                            verbose=False, mesh=mesh)
    scene = {"K": K, "mip360": {}, "H": 4, "W": 4}
    with pytest.raises(ValueError, match="bf16"):
        presets.create_nerf_model_executer(
            scene=scene, device="cpu",
            mlp_config=pnerf.NeRFConfig(compute_dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="mesh"):
        presets.create_nerf_model_executer(scene=scene, device="cpu",
                                           mesh=mesh)
    params = {"model.pts_linears.0.weight": np.zeros((2, 2), np.float32),
              "model.pts_linears.0.bias": np.zeros(2, np.float32)}
    with pytest.raises(ValueError, match="occupancy"):
        nnc_tpu_torch.compress_model(
            params, bitstream_path=str(tmp_path / "b.nnc"), lsa=True,
            scene=scene, device="cpu", verbose=False, occupancy_tuning=True)


def test_cli_compresses_decodes_and_writes_both_networks(tmp_path,
                                                         monkeypatch):
    """compress_nerf.py --config mip360_garden.txt on an LLFF fixture at
    the small size: LSA through the route's mip-NeRF 360 family, the
    bitstream, its decode and the checkpoint, the decoded weights equal to
    the reconstruction's."""
    import nnc_tpu_torch
    from test_data_loaders import make_llff_tree
    from nnc_tpu_torch import compress_nerf
    from nnc_tpu_torch.train import presets
    from nnc_tpu_torch.utils import ckpt
    data = tmp_path / "garden"
    data.mkdir()
    make_llff_tree(str(data), n=4, size=16)
    cfg = tmp_path / "m360.txt"
    text = open(os.path.join(os.path.dirname(nnc_tpu_torch.__file__),
                             "configs", "mip360_garden.txt")).read()
    cfg.write_text(text.replace("factor = 4", "factor = 2"))
    scene, extra = presets.load_scene_from_config(str(cfg), str(data))
    assert scene["ndc"] is False and scene["near"] == 0.2 and \
        scene["far"] == 1e6 and extra["n_rand"] == 16384
    assert scene["batching_mode"] == "pool" and scene["K"][0][2] == 3.5
    # the published widths are 8.7 M weights: the CLI runs them small here
    small = lambda scene, chunk=8192: mipnerf360.Mip360RenderConfig(
        **{**_rc().__dict__, "pixel_radius": 2 / (math.sqrt(12) *
                                                  float(scene["K"][0][0]))})
    monkeypatch.setattr(mipnerf360, "make_render_config", small)
    monkeypatch.setenv("NNC_TPU_TORCH_DEVICE", "cpu")
    prop, nerf = m360.from_mipnerf360_params(_tree(seed=9), prop=PROP,
                                             nerf=NERF)
    sd = {**{"model." + k: v.numpy() for k, v in prop.state_dict().items()},
          **{"model_fine." + k: v.numpy()
             for k, v in nerf.state_dict().items()}}
    tar = str(tmp_path / "m360.tar")
    ckpt.wrapper_dict_to_nerf_tar(sd, tar)
    runs = tmp_path / "runs"
    compress_nerf.main(compress_nerf.build_parser().parse_args([
        "--ckpt_path", tar, "--config", str(cfg), "--dataset_path",
        str(data), "--base_path_to_save", str(runs), "--qp", "-20",
        "--N_iters", "2", "--epochs", "1", "--i_save", "2", "--N_rand",
        "16", "--dataset_type", "llff"]))
    run = next(p for p in runs.iterdir() if p.is_dir())
    stream = next((run / "bitstream").glob("*.nnc"))
    rec = next((run / "reconstructed").glob("*_reconstructed.pt"))
    decoded = nnc_tpu_torch.decompress_model(str(stream), verbose=False)
    written = torch.load(str(rec), weights_only=True)
    assert set(decoded) == set(written) and set(sd) <= set(decoded)
    for k, v in decoded.items():
        np.testing.assert_array_equal(np.asarray(v),
                                      np.asarray(written[k]))
    assert decoded["model_fine.pts_linears.5.weight"].shape == (32, 32 + ENC)
    assert decoded["model.alpha_linear.weight"].shape == (1, 16)
    assert os.path.exists(str(rec)[:-3] + ".tar")
    ck = torch.load(str(run / "reconstructed" / "ckpt_step2.pt"),
                    weights_only=True)
    assert "model_fine.rgb_linear.weight_scaling" in ck and \
        "model.pts_linears.3.weight_scaling" in ck
