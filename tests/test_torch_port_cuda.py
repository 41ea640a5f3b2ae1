"""CUDA kernels of nnc_tpu_torch against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one.

This file imports no JAX (the machine with the card has none). Run it there
without the repository's conftest, which imports JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py

Tolerances, float32 on both sides. K-B3, K-B5 and K-B2 compute each float32
product as three TF32 products on the tensor cores (csrc/nerf_mlp_mma.cuh);
at 10x what was measured on an H100 against the exact float32 plain
versions: K-B3's and K-B5's raw outputs 3e-5 (2.4e-6 measured for K-B3 at
values up to 2.7; a single TF32 product reads 1.6e-3, a lost correction term
half of that), also against the plain model of the 3xTF32 arithmetic;
K-B2's composited rgb/acc 1e-5 (8.3e-7) and depth 1e-4 (7.9e-6; it sums
w * z, z <= 6) with early termination off, the weights 1e-4 (1.7e-5 at
sigma * dist up to ~100); 2 eps with early termination on (both versions skip
the same blocks, up to threshold ties), depth 10x that. Reruns of both are
bit-equal (a fixed order of accumulation, no atomics). K-B4's integer sums
are exact and its float32 steps
are single rounded operations in the plain version's order, so kernel and
plain version differ only where the card's sincosf and torch's sin / cos
differ in the last bit of an embedding value that sits on a quantization tie:
at most 1e-3 of the elements may differ by more than 1e-5, none by more than
the reference's bound against the float MLP (tests/test_mlp_pallas.py:255).
K-B1's gradients
(sums over every point, in another order, through relu masks that may flip
at ties): the criterion of tests/test_mlp_train_pallas.py:41-50, 99.9% of
the elements within rtol 5e-2 / atol 5e-3 of the gradient's max, and none
off by more than 5% of it. K-B6 (two float32 products as 3xTF32 on the
tensor cores, sums over at most 256 terms in another order than cuBLAS's):
1e-4 of max |ref| + 1e-5 against the exact plain version, 3e-5 against the
plain model of its arithmetic (fused_pair_3xtf32_plain; ~2e-6 expected); the
tensor-parallel forward against the dense MLP: rtol 1e-4, atol 1e-5 of the
output's scale (tests/test_parallel.py:296). The bf16 variants of K-B3,
K-B2, K-B1, K-B5 and K-B6 are held to the distance between their plain bf16
and plain float32 versions (the notes above their tests). K-B7 (the LSA
epilogue of mip-NeRF 360's GEMM layers) against its plain version: the
forward's fused multiply-add 2e-6 relative (one rounding against two), dacc
the same, the column sums of the scale and bias gradients 1e-5 of the sum
of magnitudes (up to 524,288 terms in chunks of rows, then the chunks; the
plain version sums in another order); a rerun is bit-equal.
"""
import ctypes
import math

import pytest
import torch

from nnc_tpu_torch import graft_entry, parallel
from nnc_tpu_torch.data import synthetic
from nnc_tpu_torch.models import nerf
from nnc_tpu_torch.ops import (_build, mlp_fused, mlp_tp_fused,
                               mlp_train_fused, render_fused)
from nnc_tpu_torch.ops.posenc import positional_encoding
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
    assert _build.lib().nnc_mma_params_size() == mlp_fused.MMA_PARAMS_SIZE
    sizes = [ctypes.c_int() for _ in range(2)]
    _build.lib().nnc_train_sizes(*[ctypes.byref(s) for s in sizes])
    assert [s.value for s in sizes] == [mlp_train_fused.U_SIZE,
                                        mlp_train_fused.WT_SIZE]
    sizes = [ctypes.c_int() for _ in range(2)]
    _build.lib().nnc_train_wgmma_sizes(*[ctypes.byref(s) for s in sizes])
    assert [s.value for s in sizes] == [mlp_train_fused.FWD_WG_SIZE,
                                        mlp_train_fused.BWD_WG_SIZE]
    sizes = [ctypes.c_int() for _ in range(3)]
    _build.lib().nnc_int8_sizes(*[ctypes.byref(s) for s in sizes])
    assert [s.value for s in sizes] == [mlp_fused.INT8_WQ_SIZE,
                                        mlp_fused.INT8_SCALES_SIZE,
                                        mlp_fused.INT8_BIASES_SIZE]
    assert _build.lib().nnc_int8_mma_size() == mlp_fused.INT8_MMA_SIZE


def _points(n, device, seed=2):
    g = torch.Generator().manual_seed(seed)
    pts = (4 * torch.rand(n, 3, generator=g) - 2).to(device)
    vd = torch.randn(n, 3, generator=g)
    return pts, (vd / torch.linalg.norm(vd, dim=-1, keepdim=True)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [33, 64, 10_000, 3_414_016])
def test_cuda_mlp_from_points_matches_plain(cuda_device, n):
    """One point past half a tile, one tile, a ragged last tile, and more
    tiles than one wave of persistent CTAs takes 400 times over."""
    model = _fog_model(cuda_device)
    pts, vd = _points(n, cuda_device)
    packed = mlp_fused.pack_weights(model)
    packed_mma = mlp_fused.pack_weights_mma(model)
    assert torch.equal(packed_mma, mlp_fused.repack_mma(packed))
    before = _build.launch_counts()["mlp_from_points"]
    got = mlp_fused.mlp_from_points(packed, pts, vd, packed_mma)
    torch.cuda.synchronize()
    assert _build.launch_counts()["mlp_from_points"] == before + 1
    want = mlp_fused.fused_nerf_mlp_from_points_plain(packed, pts, vd)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 3e-5
    # the plain model of the kernel's arithmetic, and what one TF32 product
    # in place of three would read
    L = mlp_fused.unpack_weights(packed)
    pe, ve = positional_encoding(pts, 10), positional_encoding(vd, 4)
    assert float((got - mlp_fused.mlp_3xtf32_plain(L, pe, ve)).abs().max()) \
        <= 3e-5
    if n >= 10_000:
        one = mlp_fused._mlp_packed(
            L, pe, ve, addmm=lambda b, x, w: b + mlp_fused.tf32_round(x)
            @ mlp_fused.tf32_round(w))
        assert float((one - want).abs().max()) > 3e-4
    # reruns are bit-equal, with the buffer given or repacked by the wrapper
    assert torch.equal(mlp_fused.mlp_from_points(packed, pts, vd, packed_mma),
                       got)
    assert torch.equal(mlp_fused.mlp_from_points(packed, pts, vd), got)
    # the model-level entry, leading shape kept
    via = mlp_fused.fused_nerf_mlp_from_points(model, pts.reshape(1, n, 3),
                                               vd.reshape(1, n, 3))
    assert via.shape == (1, n, 4) and torch.equal(via[0], got)


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["mlp_from_points", "mlp_embedded"])
def test_cuda_mma_buffer_must_be_aligned_and_sized(cuda_device, wrapper):
    """K-B3 and K-B5 refuse a fragment-ordered buffer that is misaligned,
    short or not on the card."""
    model = _fog_model(cuda_device)
    pts, vd = _points(64, cuda_device)
    inputs = (pts, vd) if wrapper == "mlp_from_points" else (
        positional_encoding(pts, 10).contiguous(),
        positional_encoding(vd, 4).contiguous())
    packed = mlp_fused.pack_weights(model)
    packed_mma = mlp_fused.repack_mma(packed)
    shifted = torch.cat([packed_mma.new_zeros(1), packed_mma])[1:]
    assert shifted.data_ptr() % 16
    run = getattr(mlp_fused, wrapper)
    before = _build.launch_counts()[wrapper]
    for bad in (shifted, packed_mma[:-64], packed_mma.cpu()):
        with pytest.raises(ValueError):
            run(packed, *inputs, bad)
    assert _build.launch_counts()[wrapper] == before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [33, 10_000, 3_414_016])
def test_cuda_mlp_embedded_matches_plain(cuda_device, n):
    """K-B5 runs K-B3's 3xTF32 chain: held to K-B3's 3e-5 against the exact
    float32 plain version and against the plain model of its arithmetic."""
    model = _fog_model(cuda_device)
    pts, vd = _points(n, cuda_device)
    pe = positional_encoding(pts, 10).contiguous()
    ve = positional_encoding(vd, 4).contiguous()
    packed = mlp_fused.pack_weights(model)
    packed_mma = mlp_fused.pack_weights_mma(model)
    before = _build.launch_counts()["mlp_embedded"]
    got = mlp_fused.mlp_embedded(packed, pe, ve, packed_mma)
    torch.cuda.synchronize()
    assert _build.launch_counts()["mlp_embedded"] == before + 1
    want = mlp_fused.fused_nerf_mlp_plain(packed, pe, ve)
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= 3e-5
    L = mlp_fused.unpack_weights(packed)
    model_3x = mlp_fused._chunked(
        lambda a, b: mlp_fused.mlp_3xtf32_plain(L, a, b), pe, ve)
    assert float((got - model_3x).abs().max()) <= 3e-5
    # reruns are bit-equal, with the buffer given or repacked by the wrapper
    assert torch.equal(mlp_fused.mlp_embedded(packed, pe, ve, packed_mma),
                       got)
    assert torch.equal(mlp_fused.mlp_embedded(packed, pe, ve), got)
    # the same chain as K-B3 on the embedding it computes itself
    from_points = mlp_fused.mlp_from_points(packed, pts, vd, packed_mma)
    assert float((got - from_points).abs().max()) <= 3e-5
    # the drop-in for apply_mlp, leading shape kept
    via = mlp_fused.fused_nerf_mlp(model, pe.reshape(1, n, 63),
                                   ve.reshape(1, n, 27))
    assert via.shape == (1, n, 4) and torch.equal(via[0], got)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [33, 64, 10_000, 3_414_016])
def test_cuda_mlp_int8_from_points_matches_plain(cuda_device, n):
    model = _fog_model(cuda_device)
    pts, vd = _points(n, cuda_device)
    packed = mlp_fused.pack_weights_int8(model)
    before = _build.launch_counts()["mlp_int8_from_points"]
    got = mlp_fused.mlp_int8_from_points(*packed, pts, vd)
    torch.cuda.synchronize()
    assert _build.launch_counts()["mlp_int8_from_points"] == before + 1
    want = mlp_fused.fused_nerf_mlp_int8_from_points_plain(*packed, pts, vd)
    ref = mlp_fused.mlp_from_points(mlp_fused.pack_weights(model), pts, vd)
    bound = 0.05 * float(ref.abs().max()) + 0.05
    d = (got - want).abs()
    assert torch.isfinite(got).all()
    assert float((d > 1e-5).float().mean()) <= 1e-3
    assert float(d.max()) < bound
    assert 0 < float((got - ref).abs().max()) < bound


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 65, 127, 129, 20_000 + 64])
def test_cuda_mlp_int8_tensor_cores_reruns_and_blocks(cuda_device, n):
    """K-B4 on the tensor cores at sizes that end inside, or exactly after,
    the first of a 128-point tile's two activation-scale blocks: against
    the plain version, bit-equal reruns, a given buffer and the one the
    wrapper makes alike, and each 64-point block's output the same as that
    block launched alone (its scale is its own)."""
    model = _fog_model(cuda_device, seed=3)
    pts, vd = _points(n, cuda_device, seed=5)
    packed = mlp_fused.pack_weights_int8(model)
    buf = mlp_fused.pack_weights_int8_mma(model)
    assert torch.equal(buf, mlp_fused.repack_int8_mma(*packed))
    got = mlp_fused.mlp_int8_from_points(*packed, pts, vd, packed_s8=buf)
    torch.cuda.synchronize()
    assert torch.equal(mlp_fused.mlp_int8_from_points(*packed, pts, vd), got)
    assert torch.equal(mlp_fused.mlp_int8_from_points(
        *packed, pts, vd, packed_s8=buf), got)
    want = mlp_fused.fused_nerf_mlp_int8_from_points_plain(*packed, pts, vd)
    d = (got - want).abs()
    assert torch.isfinite(got).all()
    assert float((d > 1e-5).float().mean()) <= 1e-3
    blk = mlp_fused.INT8_ACT_BLOCK
    for lo in range(0, min(n, 3 * blk), blk):
        hi = min(lo + blk, n)
        alone = mlp_fused.mlp_int8_from_points(
            *packed, pts[lo:hi].contiguous(), vd[lo:hi].contiguous(),
            packed_s8=buf)
        assert torch.equal(alone, got[lo:hi]), (lo, hi)
    with pytest.raises(ValueError):
        mlp_fused.mlp_int8_from_points(*packed, pts, vd, packed_s8=buf[1:])


@pytest.mark.cuda
def test_cuda_renderer_int8_and_embedded_routes(cuda_device):
    """use_int8_mlp launches K-B4 and stays within the reference's bound of
    the float render (tests/test_mlp_pallas.py:274) on every ray whose far
    sample cannot change sign; the MLP called as
    fused_nerf_mlp on embeddings made outside launches K-B5 and gives K-B3's
    render but for rays that a last-bit difference moves to other samples."""
    model = _fog_model(cuda_device)
    ro, rd, vd, _z = _rays(100, 8, cuda_device)
    ro = ro + torch.tensor([0.0, 0.0, 4.0], device=cuda_device)
    common = dict(n_samples=16, n_importance=16, perturb=False,
                  use_fused_mlp=True, raw_noise_std=1.0)
    render = lambda rc: renderer.render_rays(model, None, ro, rd, vd, 2.0,
                                             6.0, rc, deterministic=True)
    exact = render(renderer.RenderConfig(**common))
    before = _build.launch_counts()
    int8 = render(renderer.RenderConfig(**common, use_int8_mlp=True))
    after = _build.launch_counts()
    assert after["mlp_int8_from_points"] == \
        before["mlp_int8_from_points"] + 2
    assert after["mlp_from_points"] == before["mlp_from_points"]
    # raw2outputs gives a ray's last sample (dist 1e10) alpha 1 or 0 by the
    # sign of its sigma: rays whose far sample the float model puts within
    # the int8 error of zero may flip, every other ray is held to the bound
    raw_far = mlp_fused.fused_nerf_mlp_from_points(model, ro + rd * 6.0, vd)
    steady = raw_far[:, 3].abs() > 0.05 * raw_far.abs().max() + 0.05
    d = (int8["rgb_map"] - exact["rgb_map"]).abs().amax(dim=-1)
    assert int(steady.sum()) >= 50
    assert 0 < float(d[steady].max()) < 0.1
    # the kernel against the same render through its plain version: they
    # agree bit for bit but for a flipped tie, far-sample steps included
    real = mlp_fused.mlp_int8_from_points
    mlp_fused.mlp_int8_from_points = \
        mlp_fused.fused_nerf_mlp_int8_from_points_plain
    try:
        plain = render(renderer.RenderConfig(**common, use_int8_mlp=True))
    finally:
        mlp_fused.mlp_int8_from_points = real
    assert _build.launch_counts()["mlp_int8_from_points"] == \
        after["mlp_int8_from_points"]
    d = (int8["rgb_map"] - plain["rgb_map"]).abs().amax(dim=-1)
    assert int((d > 1e-5).sum()) <= 1

    def embedded(m, pts, viewdirs, rc, allow_fused=True):
        ve = positional_encoding(viewdirs, 4)
        return mlp_fused.fused_nerf_mlp(
            m, positional_encoding(pts, 10),
            ve[..., None, :].expand(*pts.shape[:-1], 27))

    real = renderer._query_mlp
    renderer._query_mlp = embedded
    try:
        emb = render(renderer.RenderConfig(**common))
    finally:
        renderer._query_mlp = real
    assert _build.launch_counts()["mlp_embedded"] == \
        after["mlp_embedded"] + 2
    # K-B5 and K-B3 run one 3xTF32 chain on embeddings that torch's sin /
    # cos and the kernel's sincosf make a last bit apart: their raw outputs
    # differ by ~1e-6, which moves a pixel by less than 1e-4 unless a coarse
    # weight crosses one of sample_pdf's bin edges (or the far sample's
    # sigma crosses zero) and the ray takes other fine samples
    d = (emb["rgb_map"] - exact["rgb_map"]).abs().amax(dim=-1)
    assert int((d > 1e-4).sum()) <= 2 and float(d.max()) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("R,S", [(333, 80), (64, 192), (7, 33)])
@pytest.mark.parametrize("eps,want_weights", [(0.0, True), (1e-4, True),
                                              (1e-4, False)])
def test_cuda_render_pass_matches_plain(cuda_device, eps, want_weights, R, S):
    """R odd (a ragged ray tile) with S no multiple of the sample block, whole
    tiles and blocks, and fewer rays than one culling group."""
    model = synthetic.make_solid_mlp(noise_std=1e-2, device=cuda_device,
                                     generator=torch.Generator()
                                     .manual_seed(3))
    ro, rd, vd, z = _rays(R, S, cuda_device)
    ro = ro + torch.tensor([0.0, 0.0, 4.0], device=cuda_device)
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)],
                      -1) * torch.linalg.norm(rd, dim=-1, keepdim=True)
    live = (torch.arange(R, device=cuda_device) % 128 < 64).to(torch.int32)
    live[R // 2:R // 2 + 4] = 0   # dead ray tiles at every R
    term = -math.log(eps) if eps > 0 else math.inf
    packed = mlp_fused.pack_weights(model)
    packed_mma = mlp_fused.repack_mma(packed)
    args = (packed, ro, rd, vd, z, dists, live, term, want_weights)
    before = _build.launch_counts()["render_pass"]
    maps, w = render_fused.render_pass(*args, packed_mma=packed_mma)
    torch.cuda.synchronize()
    assert _build.launch_counts()["render_pass"] == before + 1
    maps_p, w_p = render_fused.fused_render_pass_plain(*args)
    tol, tol_w, tol_depth = (1e-5, 1e-4, 1e-4) if eps == 0 else \
        (2 * eps, 2 * eps, 20 * eps)
    assert torch.isfinite(maps).all()
    assert float((maps[:, :4] - maps_p[:, :4]).abs().max()) <= tol
    assert float((maps[:, 4] - maps_p[:, 4]).abs().max()) <= tol_depth
    # rays of the tiles (RAY_TILE rays) in which no ray is live: exact zeros
    rt = render_fused.RAY_TILE
    dead = torch.nn.functional.pad(live, (0, -R % rt)).reshape(-1, rt) \
        .amax(dim=1).repeat_interleave(rt)[:R] == 0
    assert int(dead.sum()) >= 2 and float(maps[dead].abs().max()) == 0.0
    assert float(maps[:, 3].max()) > 0.5  # rays reach the solid
    if want_weights:
        assert float((w - w_p).abs().max()) <= tol_w
        assert float(w[dead].abs().max()) == 0.0
    else:
        assert w is None
    # reruns are bit-equal, with the buffer given or repacked by the wrapper
    for again in (render_fused.render_pass(*args, packed_mma=packed_mma),
                  render_fused.render_pass(*args)):
        assert torch.equal(again[0], maps)
        assert w is None or torch.equal(again[1], w)


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
        assert not any(_build.launch_counts().values())
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


def _grads_close(got, want, what):
    scale = max(float(want.abs().max()), 1e-12)
    close = torch.isclose(got, want, rtol=5e-2, atol=5e-3 * scale)
    assert float(close.float().mean()) > 0.999, (what, close.float().mean())
    assert float((got - want).abs().max()) < 0.05 * scale, what


@pytest.mark.cuda
@pytest.mark.parametrize("n,with_dw", [(10_000, False), (10_000, True),
                                       (4096, False), (33, False),
                                       (16_401, False), (196_608, False),
                                       (32_768, False), (65_536, False),
                                       (131_072, False)])
def test_cuda_mlp_train_matches_plain(cuda_device, n, with_dw):
    """K-B1 forward and backward against the plain versions; 33, 10,000 and
    16,401 are no multiples of the 64-point tile (the ragged tail; the last
    is a mesh shard's size and a bit; 33 and 16,401 also an odd number of
    tiles, so that one CTA of a cluster runs a tile past the data), 196,608
    is the LSA step's fine pass, more tiles than one wave of persistent CTAs
    takes 23 times over, 32,768 the occupancy loss's points, 65,536 the
    coarse pass, 131,072 fern's fine pass. The forward and the backward
    without dW run 3xTF32 products: raw within 3e-5 of the exact float32
    plain version (TOL of K-B3). Two runs give the same bits: raw, the
    workspace, dls, db and (with dW) every du."""
    model = _fog_model(cuda_device)
    g = torch.Generator().manual_seed(6)
    pts = (2 * torch.randn(n, 3, generator=g)).to(cuda_device)
    vd = torch.randn(n, 3, generator=g).to(cuda_device)
    cot = torch.randn(n, 4, generator=g).to(cuda_device)
    tensors = mlp_train_fused._layer_tensors(model)
    params, params_t, ls = mlp_train_fused.pack_train(
        tensors[0::3], tensors[1::3], tensors[2::3])
    before = _build.launch_counts()
    raw, ws = mlp_train_fused.mlp_train_fwd(params, ls, pts, vd, save_u=True)
    flat = mlp_train_fused.mlp_train_bwd(params, params_t, ls, pts, vd, cot,
                                         ws, with_dw)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    bwd = "mlp_train_bwd_dw" if with_dw else "mlp_train_bwd"
    assert after["mlp_train_fwd"] == before["mlp_train_fwd"] + 1
    assert after[bwd] == before[bwd] + 1
    assert ws.shape == (-(-n // 64) * 64, mlp_train_fused.U_SIZE)
    assert torch.isfinite(ws).all()
    raw_p = mlp_train_fused.mlp_train_fwd_plain(params, ls, pts, vd)
    assert float((raw - raw_p).abs().max()) <= 3e-5
    # without the workspace the forward gives the same bits
    raw0, none = mlp_train_fused.mlp_train_fwd(params, ls, pts, vd)
    assert none is None and torch.equal(raw0, raw)
    flat_p = mlp_train_fused.mlp_train_bwd_plain(params, params_t, ls, pts,
                                                 vd, cot, with_dw)
    assert flat.shape == flat_p.shape == (mlp_train_fused.grad_size(with_dw),)
    assert torch.isfinite(flat).all()
    for part, got, want in zip(("dW", "dls", "db"),
                               mlp_train_fused.split_grads(flat, with_dw),
                               mlp_train_fused.split_grads(flat_p, with_dw)):
        if got is None:
            continue
        for name in got:
            _grads_close(got[name], want[name], f"{part} {name}")
    # the sum over CTAs is taken in a fixed order: bit-identical reruns,
    # also from the cached buffers in place of those made from pack_train's
    packed_wg, packed_wg_t = mlp_train_fused.pack_train_wgmma(tensors[0::3])
    biases = mlp_train_fused.gather_biases(params)
    again = mlp_train_fused.mlp_train_bwd(
        None if not with_dw else params, None if not with_dw else params_t,
        ls, pts, vd, cot, ws, with_dw, packed_wg_t=packed_wg_t, biases=biases)
    assert torch.equal(again, flat)
    raw_c, ws_c = mlp_train_fused.mlp_train_fwd(
        None, ls, pts, vd, save_u=True, packed_wg=packed_wg, biases=biases)
    assert torch.equal(raw_c, raw) and torch.equal(ws_c, ws)
    if with_dw:
        dus = [torch.full_like(ws, float("nan")) for _ in range(2)]
        flats = [mlp_train_fused.mlp_train_bwd(
            None, None, ls, pts, vd, cot, ws_c, True, packed_wg_t, biases,
            du=d) for d in dus]
        assert torch.equal(flats[0], flat) and torch.equal(flats[1], flat)
        assert torch.equal(dus[0], dus[1])


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("n", [0, 33, 16_401, 196_608])
def test_cuda_mlp_train_dw_two_passes(cuda_device, bf16, n):
    """K-B1's backward with dW in two passes: the du workspace, then the
    GEMM over the points (csrc/mlp_train_dw.cu), against the plain versions
    at the gradients' bars (float32: the criterion above; bf16: the
    bf16-to-float32 distance's, dW a bf16 value), and the GEMM on the
    kernels' own workspaces against its plain version. The du workspace has
    du = 0 in the rows past n of the first pass's whole 64-point tiles, and
    the rows past those are neither written nor read (NaN in, NaN out, no
    NaN in dW), nor the bf16 workspace's padding columns (its rows are
    DU_COLS_BF16 long). Reruns are bit-equal. n = 0: zeros."""
    model = _fog_model(cuda_device)
    g = torch.Generator().manual_seed(16)
    pts = (4 * torch.rand(n, 3, generator=g) - 2).to(cuda_device)
    vd = torch.randn(n, 3, generator=g)
    vd = (vd / torch.linalg.norm(vd, dim=-1, keepdim=True).clamp(min=1e-6)) \
        .to(cuda_device)
    cot = (1e-2 * torch.randn(n, 4, generator=g)).to(cuda_device)
    tensors = mlp_train_fused._layer_tensors(model)
    params, params_t, ls = mlp_train_fused.pack_train(
        tensors[0::3], tensors[1::3], tensors[2::3])
    biases = mlp_train_fused.gather_biases(params)
    M = mlp_train_fused
    fwd, bwd = (M.mlp_train_fwd_bf16, M.mlp_train_bwd_bf16) if bf16 else \
        (M.mlp_train_fwd, M.mlp_train_bwd)
    packed, packed_t = (M.pack_train_bf16 if bf16 else
                        M.pack_train_wgmma)(tensors[0::3])
    _raw, ws = fwd(params, ls, pts, vd, True, packed, biases)
    du = torch.full((ws.shape[0], M.DU_COLS_BF16 if bf16 else M.U_SIZE),
                    float("nan"), device=cuda_device,
                    dtype=torch.bfloat16 if bf16 else torch.float32)
    name = "mlp_train_bwd_dw_bf16" if bf16 else "mlp_train_bwd_dw"
    before = _build.launch_counts()[name]
    flat = bwd(None, None, ls, pts, vd, cot, ws, True, packed_t, biases,
               du=du)
    torch.cuda.synchronize()
    assert _build.launch_counts()[name] == before + 1
    assert flat.shape == (M.grad_size(True),) and torch.isfinite(flat).all()
    rows = -(-n // 64) * 64
    U = M.U_SIZE
    assert torch.isfinite(du[:rows, :U]).all() and \
        bool((du[n:rows, :U] == 0).all())
    # the rows past the first pass's tiles, and the bf16 rows' padding
    assert bool(du[rows:].isnan().all()) and bool(du[:, U:].isnan().all())
    again = bwd(None, None, ls, pts, vd, cot, ws, True, packed_t, biases)
    assert torch.equal(again, flat)
    # dls and db are those of the backward without dW, bit for bit
    without = bwd(None, None, ls, pts, vd, cot, ws, False, packed_t, biases)
    assert torch.equal(flat[M.WT_SIZE:], without)
    if n == 0:
        assert float(flat.abs().max()) == 0.0
        return
    # the GEMM against its plain version on the kernels' workspaces
    dw_plain = M.mlp_train_dw_plain(ws, du.float(), ls, biases, pts, vd,
                                    bf16=bf16)
    if bf16:
        dw = flat[:M.WT_SIZE]
        assert torch.equal(dw, mlp_fused.bf16_round(dw))
        step = 2.0 ** -7 * dw_plain.abs()
        assert float(((dw - dw_plain).abs() - step).max()) <= \
            1e-5 * float(dw_plain.abs().max())
        _grads_to_bf16_distance(
            flat, M.mlp_train_bwd_bf16_plain(params, params_t, ls, pts, vd,
                                             cot, True),
            M.mlp_train_bwd_plain(params, params_t, ls, pts, vd, cot, True),
            True)
    else:
        assert float((flat[:M.WT_SIZE] - dw_plain).abs().max()) <= \
            1e-5 * float(dw_plain.abs().max())
        want = M.mlp_train_bwd_plain(params, params_t, ls, pts, vd, cot, True)
        for part, got_d, want_d in zip(("dW", "dls", "db"),
                                       M.split_grads(flat, True),
                                       M.split_grads(want, True)):
            for layer in got_d:
                _grads_close(got_d[layer], want_d[layer], f"{part} {layer}")


@pytest.mark.cuda
def test_cuda_train_wrappers_need_their_buffers(cuda_device):
    pts, vd = _points(64, cuda_device)
    ls = torch.ones(mlp_train_fused.U_SIZE, device=cuda_device)
    with pytest.raises(ValueError, match="neither"):
        mlp_train_fused.mlp_train_fwd(None, ls, pts, vd)
    packed = torch.zeros(mlp_train_fused.FWD_WG_SIZE, device=cuda_device)
    with pytest.raises(ValueError, match="device"):
        mlp_train_fused.mlp_train_fwd(None, ls, pts, vd,
                                      packed_wg=packed.cpu(), biases=ls)
    raw, ws = mlp_train_fused.mlp_train_fwd(None, ls, pts, vd, save_u=True,
                                            packed_wg=packed, biases=ls)
    # with dW as without: the backward's buffer, or params_t to make it from
    with pytest.raises(ValueError, match="neither"):
        mlp_train_fused.mlp_train_bwd(None, None, ls, pts, vd, raw, ws, True)
    with pytest.raises(ValueError, match="du workspace"):
        mlp_train_fused.mlp_train_bwd(None, None, ls, pts, vd, raw, ws, False,
                                      du=torch.empty_like(ws))


@pytest.mark.cuda
def test_cuda_lsa_run_packs_the_weights_once(cuda_device):
    """k LSA steps through K-B1 look each model's weight buffers up once a
    step: two misses (coarse, fine), 2 (k - 1) hits."""
    from nnc_tpu_torch.train import lsa, presets
    k = 4
    g = torch.Generator().manual_seed(9)
    teachers = tuple(synthetic.make_solid_mlp(noise_std=1e-2, generator=g,
                                              device=cuda_device)
                     for _ in range(2))
    rc = renderer.RenderConfig(n_samples=16, n_importance=16,
                               white_bkgd=True)
    scene, _ = synthetic.make_scene(n_images=3, H=24, W=24, rc=rc, near=2.0,
                                    far=6.0, teachers=teachers,
                                    device=cuda_device)
    scene.update(n_importance=16, raw_noise_std=0.0)
    ex = presets.create_nerf_model_executer(
        scene=scene, device=cuda_device, use_fused_mlp=True, n_rand=64,
        n_samples=16, verbose=False)
    sd = nerf.params_to_state_dict(teachers[0], "model.")
    sd.update(nerf.params_to_state_dict(teachers[1], "model_fine."))
    models = ex._split_params(sd)
    cache = mlp_train_fused.TRAIN_PACKS
    hits, misses = cache.hits, cache.misses
    before = _build.launch_counts()
    lsa.tune_lsa_scales(*models, ex._make_batcher(), ex.rc, scene["near"],
                        scene["far"], epochs=1, n_iters=k, verbose=False)
    after = _build.launch_counts()
    assert after["mlp_train_fwd"] - before["mlp_train_fwd"] == 2 * k
    assert after["mlp_train_bwd"] - before["mlp_train_bwd"] == 2 * k
    assert (cache.misses - misses, cache.hits - hits) == (2, 2 * (k - 1))


@pytest.mark.cuda
def test_cuda_fused_train_autograd(cuda_device):
    """fused_nerf_mlp_train through autograd on the card against the plain
    MLP's torch autograd: scale and bias grads real, weight grads zero
    without with_dw."""
    model = _fog_model(cuda_device)
    for layer in model.layers().values():
        for t in (layer.weight, layer.bias, layer.weight_scaling):
            t.requires_grad_(True)
    g = torch.Generator().manual_seed(7)
    pts = (2 * torch.randn(33, 61, 3, generator=g)).to(cuda_device)
    vd = torch.randn(33, 1, 3, generator=g).to(cuda_device)
    tgt = torch.randn(33, 61, 4, generator=g).to(cuda_device)
    raw = mlp_train_fused.fused_nerf_mlp_train(model, pts, vd)
    ((raw - tgt) ** 2).mean().backward()
    got = {n: (l.weight.grad, l.bias.grad, l.weight_scaling.grad)
           for n, l in model.layers().items()}
    for layer in model.layers().values():
        layer.weight.grad = layer.bias.grad = layer.weight_scaling.grad = None
    from nnc_tpu_torch.ops.posenc import positional_encoding
    want = nerf.apply_mlp(model, positional_encoding(pts, 10),
                          positional_encoding(vd.expand_as(pts), 4),
                          output_scaling=True)
    assert float((raw - want).abs().max()) <= 1e-3
    ((want - tgt) ** 2).mean().backward()
    for n, layer in model.layers().items():
        gw, gb, gl = got[n]
        assert float(gw.abs().max()) == 0.0
        _grads_close(gb, layer.bias.grad, f"{n}.bias")
        _grads_close(gl, layer.weight_scaling.grad, f"{n}.weight_scaling")


PAIR_HEADS = ((63, 256, True), (256, 256, True), (256, 128, False))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [262_144, 10_001])
@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_cuda_mlp_tp_pair_matches_plain(cuda_device, m, n):
    """K-B6 at every (K, S, O2, relu_mid) the forward uses with M shards,
    at 262,144 points and at a count that is no multiple of the tile."""
    g = torch.Generator().manual_seed(8)
    s = 256 // m
    for k, o2, relu_mid in PAIR_HEADS:
        x = torch.randn(n, k, generator=g).to(cuda_device)
        wa = (torch.randn(k, s, generator=g) / k ** 0.5).to(cuda_device)
        ba = torch.randn(s, generator=g).to(cuda_device)
        wb = (torch.randn(s, o2, generator=g) / s ** 0.5).to(cuda_device)
        before = _build.launch_counts()["mlp_tp_pair"]
        got = mlp_tp_fused.fused_pair(x, wa, ba, wb, relu_mid)
        torch.cuda.synchronize()
        assert _build.launch_counts()["mlp_tp_pair"] == before + 1
        want = mlp_tp_fused.fused_pair_plain(x, wa, ba, wb, relu_mid)
        assert got.shape == (n, o2) and torch.isfinite(got).all()
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max()) + 1e-5, (k, s, o2)
        model = mlp_tp_fused.fused_pair_3xtf32_plain(x, wa, ba, wb, relu_mid)
        assert float((got - model).abs().max()) <= 3e-5, (k, s, o2)
        # every sum runs in a fixed order: bit-identical reruns
        assert torch.equal(got, mlp_tp_fused.fused_pair(x, wa, ba, wb,
                                                        relu_mid))
    with pytest.raises(ValueError, match="no kernel"):
        mlp_tp_fused.fused_pair(x, wa, ba, wb, True)    # (128, True)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [63, 200, 256])
def test_cuda_mlp_tp_pair_any_alignment_of_x(cuda_device, k):
    """x at an offset of one float (the kernel's 4-byte copies) and K that is
    no multiple of 32 give the model's values; weights that are not 16-byte
    aligned are refused."""
    g = torch.Generator().manual_seed(10)
    n = 1_000
    flat = torch.randn(n * k + 1, generator=g).to(cuda_device)
    x = flat[1:].view(n, k)
    wa = (torch.randn(k, 64, generator=g) / k ** 0.5).to(cuda_device)
    ba = torch.randn(64, generator=g).to(cuda_device)
    wb = (torch.randn(64, 256, generator=g) / 8).to(cuda_device)
    got = mlp_tp_fused.fused_pair(x, wa, ba, wb)
    model = mlp_tp_fused.fused_pair_3xtf32_plain(x, wa, ba, wb)
    assert float((got - model).abs().max()) <= 3e-5
    assert torch.equal(got, mlp_tp_fused.fused_pair(x.clone(), wa, ba, wb))
    shifted = torch.cat([wb.reshape(-1).new_zeros(1), wb.reshape(-1)])[1:]
    with pytest.raises(ValueError, match="aligned"):
        mlp_tp_fused.fused_pair(x, wa, ba, shifted.reshape(64, 256))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_cuda_fused_nerf_mlp_tp_matches_dense(cuda_device, m):
    """The tensor-parallel forward on a mesh of M x cuda:0 against the dense
    MLP and against K-B5, 5 launches per shard."""
    model = _fog_model(cuda_device)
    n = 20_001
    pts, vd = _points(n, cuda_device)
    pe = positional_encoding(pts, 10).contiguous()
    ve = positional_encoding(vd, 4).contiguous()
    mesh = parallel.make_mesh(m, ("model",))
    assert all(d == cuda_device for d in mesh.devices.flat)
    before = _build.launch_counts()["mlp_tp_pair"]
    with torch.no_grad():
        got = mlp_tp_fused.fused_nerf_mlp_tp(model, pe, ve, mesh)
        torch.cuda.synchronize()
        assert _build.launch_counts()["mlp_tp_pair"] == before + 5 * m
        dense = nerf.apply_mlp(model, pe, ve)
        kb5 = mlp_fused.fused_nerf_mlp(model, pe, ve)
    scale = float(dense.abs().max())
    for want in (dense, kb5):
        assert torch.allclose(got, want, rtol=1e-4, atol=1e-5 * scale)


@pytest.mark.cuda
def test_cuda_dryrun_multichip_and_entry(cuda_device, capsys):
    graft_entry.dryrun_multichip(4)
    out = capsys.readouterr().out
    assert "TP fused MLP OK" in out and "joint==sequential" in out
    fn, args = graft_entry.entry()
    rgb = fn(*args)
    assert rgb.shape == (1024, 3) and rgb.device == cuda_device
    assert torch.isfinite(rgb).all()


# --- the bf16 variants of K-B3 and K-B2 ---------------------------------------
# A bf16 result is held against its plain bf16 version in units of the
# distance between the plain bf16 and the plain float32 version on the same
# network and inputs: one float32 sum rounded the other way flips a bf16
# rounding (2^-8 of an activation), and the tensor core's cutting accumulate
# does that to about one activation a point. Measured on an H100 at 262,144
# points: rms 0.057 of the distance's rms, max 0.45-0.52 of its max. Bars:
# rms <= 1/8, no element beyond the distance's max, at most 1e-4 of them
# beyond half of it, and three times closer (rms) to the plain bf16 version
# than to the plain float32 one.
def _rms(t):
    return float(t.double().pow(2).mean().sqrt())


def _held_to_bf16_distance(got, plain16, plain32):
    err, dist = got - plain16, plain16 - plain32
    assert _rms(dist) > 0
    assert _rms(err) <= _rms(dist) / 8, (_rms(err), _rms(dist))
    top = float(dist.abs().max())
    assert float(err.abs().max()) <= top, (float(err.abs().max()), top)
    assert float((err.abs() > top / 2).float().mean()) <= 1e-4
    assert 3 * _rms(err) <= _rms(got - plain32)


@pytest.mark.cuda
def test_cuda_bf16_build_and_layout(cuda_device):
    lib = _build.lib()
    assert lib.nnc_bf16_params_size() == mlp_fused.BF16_PARAMS_SIZE
    assert lib.nnc_bf16_tile_points() == \
        render_fused.SLOTS_BF16 * render_fused.SAMPLE_BLOCK
    assert lib.nnc_bf16_wgmma_size() == mlp_fused.WG_SIZE


@pytest.mark.cuda
@pytest.mark.parametrize("n", [33, 64, 10_000, 3_414_016])
def test_cuda_mlp_from_points_bf16_matches_plain(cuda_device, n):
    model = _fog_model(cuda_device)
    pts, vd = _points(n, cuda_device)
    packed = mlp_fused.pack_weights(model)
    buf = mlp_fused.pack_weights_bf16(model)
    assert torch.equal(buf, mlp_fused.repack_bf16(packed))
    before = _build.launch_counts()
    got = mlp_fused.mlp_from_points_bf16(buf, pts, vd)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert after["mlp_from_points_bf16"] == before["mlp_from_points_bf16"] + 1
    assert after["mlp_from_points"] == before["mlp_from_points"]
    assert torch.isfinite(got).all()
    _held_to_bf16_distance(
        got, mlp_fused.fused_nerf_mlp_from_points_bf16_plain(buf, pts, vd),
        mlp_fused.fused_nerf_mlp_from_points_plain(packed, pts, vd))
    assert torch.equal(mlp_fused.mlp_from_points_bf16(buf, pts, vd), got)
    # the wgmma slabs given (as the model-level entry passes them) or made
    # by the wrapper: the same kernel, the same bytes
    wg = mlp_fused.repack_bf16_wgmma(buf)
    assert torch.equal(wg, mlp_fused.repack_bf16_wgmma(buf.cpu()).cuda())
    assert torch.equal(
        mlp_fused.mlp_from_points_bf16(buf, pts, vd, packed_wg=wg), got)
    assert _build.launch_counts()["mlp_from_points_bf16"] == \
        before["mlp_from_points_bf16"] + 3
    # the model-level entry picks the variant from the config
    bf16_model = nerf.NeRF(nerf.NeRFConfig(compute_dtype=torch.bfloat16),
                           device=cuda_device)
    bf16_model.load_state_dict(model.state_dict(), strict=False)
    for src, dst in zip(model.layers().values(),
                        bf16_model.layers().values()):
        dst.weight_scaling = src.weight_scaling
    via = mlp_fused.fused_nerf_mlp_from_points(bf16_model,
                                               pts.reshape(1, n, 3),
                                               vd.reshape(1, n, 3))
    assert via.shape == (1, n, 4) and torch.equal(via[0], got)
    assert _build.launch_counts()["mlp_from_points"] == \
        before["mlp_from_points"]


@pytest.mark.cuda
def test_cuda_bf16_buffer_must_be_aligned_and_sized(cuda_device):
    model = _fog_model(cuda_device)
    pts, vd = _points(64, cuda_device)
    buf = mlp_fused.pack_weights_bf16(model)
    shifted = torch.cat([buf.new_zeros(1), buf])[1:]
    assert shifted.data_ptr() % 16
    for bad in (shifted, buf[:-64], buf.cpu(), buf.float()):
        with pytest.raises(ValueError):
            mlp_fused.mlp_from_points_bf16(bad, pts, vd)


@pytest.mark.cuda
def test_cuda_wgmma_buffer_must_be_aligned_and_sized(cuda_device):
    """K-B3 bf16's slabs reach the ring by 16-byte bulk copies: a misaligned,
    wrong-sized, wrongly typed or misplaced packed_wg raises, with no launch
    and no fallback."""
    model = _fog_model(cuda_device)
    pts, vd = _points(64, cuda_device)
    buf = mlp_fused.pack_weights_bf16(model)
    wg = mlp_fused.repack_bf16_wgmma(buf)
    shifted = torch.cat([wg.new_zeros(1), wg])[1:]
    assert shifted.data_ptr() % 16
    before = _build.launch_counts()["mlp_from_points_bf16"]
    for bad in (shifted, wg[:-4], wg.cpu(), wg.float()):
        with pytest.raises(ValueError):
            mlp_fused.mlp_from_points_bf16(buf, pts, vd, packed_wg=bad)
    assert _build.launch_counts()["mlp_from_points_bf16"] == before


@pytest.mark.cuda
def test_cuda_wgmma_probe_one_layer_matches_torch_mm(cuda_device):
    """One warpgroup's wgmma layer (m64n256k16 and m64n128k16, K 256, A and
    B from shared memory through nerf_mlp_wgmma.cuh's swizzle and
    descriptors; tools/mma_probe.py section 10) against torch.mm of the same
    bf16 values in float32: sums of 256 exact products in another order,
    within 1e-4 of the largest output (3.1e-5 of 65 measured on an H100; a
    wrong descriptor reads other values and misses by the output itself)."""
    from nnc_tpu_torch.tools import mma_probe
    lib, _log = mma_probe.build_wgmma_probe()
    for n_out, (err, top) in mma_probe.wgmma_layer_errors(
            lib, cuda_device).items():
        assert top > 10 and err <= 1e-4 * top, (n_out, err, top)


@pytest.mark.cuda
@pytest.mark.parametrize("R,S", [(333, 80), (64, 192), (7, 33),
                                 (20_000, 64)])
@pytest.mark.parametrize("eps,want_weights", [(0.0, True), (1e-4, True),
                                              (1e-4, False)])
def test_cuda_render_pass_bf16_matches_plain(cuda_device, eps, want_weights,
                                             R, S):
    """K-B2 bf16 (early termination per ray, persistent CTAs on a ray
    queue; 20,000 rays are many more than the slots of one CTA per SM)
    against its plain version at ray_tile = RAY_TILE_BF16 = 1; culled rays
    write zeros; reruns bit-equal whatever order the queue hands rays out
    in."""
    model = synthetic.make_solid_mlp(noise_std=1e-2, device=cuda_device,
                                     generator=torch.Generator()
                                     .manual_seed(3))
    ro, rd, vd, z = _rays(R, S, cuda_device)
    ro = ro + torch.tensor([0.0, 0.0, 4.0], device=cuda_device)
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)],
                      -1) * torch.linalg.norm(rd, dim=-1, keepdim=True)
    live = (torch.arange(R, device=cuda_device) % 128 < 64).to(torch.int32)
    live[R // 2:R // 2 + 8] = 0   # dead ray tiles at every R
    term = -math.log(eps) if eps > 0 else math.inf
    packed = mlp_fused.pack_weights(model)
    buf = mlp_fused.repack_bf16(packed)
    rays = (ro, rd, vd, z, dists, live, term)
    before = _build.launch_counts()
    maps, w = render_fused.render_pass_bf16(buf, *rays, want_weights)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert after["render_pass_bf16"] == before["render_pass_bf16"] + 1
    assert after["render_pass"] == before["render_pass"]
    maps_p, w_p = render_fused.fused_render_pass_bf16_plain(buf, *rays)
    # the float32 plain version stopping each ray alone, as the kernel
    maps_f, w_f = render_fused.fused_render_pass_plain(
        packed, *rays, ray_tile=render_fused.RAY_TILE_BF16)
    assert torch.isfinite(maps).all()
    for name, a, b, c, slack in (
            # (the float32 kernel's own 1e-5 is the floor: a solid's rgb / acc
            # differ by float32 rounding alone)
            ("rgb/acc", maps[:, :4], maps_p[:, :4], maps_f[:, :4],
             2 * eps + 1e-5),
            ("depth", maps[:, 4], maps_p[:, 4], maps_f[:, 4], 20 * eps)) + (
            (("weights", w, w_p, w_f, 2 * eps),) if want_weights else ()):
        dist = float((b - c).abs().max())
        assert dist > 0 and float((a - b).abs().max()) <= dist / 2 + slack, \
            (name, float((a - b).abs().max()), dist)
    rt = render_fused.RAY_TILE_BF16
    dead = torch.nn.functional.pad(live, (0, -R % rt)).reshape(-1, rt) \
        .amax(dim=1).repeat_interleave(rt)[:R] == 0
    assert int(dead.sum()) >= 3 and float(maps[dead].abs().max()) == 0.0
    assert float(maps[:, 3].max()) > 0.5  # rays reach the solid
    if want_weights:
        assert float(w[dead].abs().max()) == 0.0
    else:
        assert w is None
    again = render_fused.render_pass_bf16(buf, *rays, want_weights)
    assert torch.equal(again[0], maps)
    assert w is None or torch.equal(again[1], w)
    for bad in (buf[:-64], buf.cpu(), packed):
        with pytest.raises(ValueError):
            render_fused.render_pass_bf16(bad, *rays, want_weights)


@pytest.mark.cuda
def test_cuda_bf16_renderer_routes_to_the_bf16_kernels(cuda_device):
    """render_rays of a bf16 model: K-B2 bf16 for the coarse and the fine
    pass, K-B3 bf16 with raw_noise_std > 0, none of the float32 kernels; the
    result within the culled render's bound of the plain bf16 path."""
    cfg = nerf.NeRFConfig(compute_dtype=torch.bfloat16)
    models = [synthetic.make_solid_mlp(cfg, noise_std=1e-2,
                                       device=cuda_device,
                                       generator=torch.Generator()
                                       .manual_seed(s)) for s in (4, 5)]
    assert all(m.config.compute_dtype == torch.bfloat16 for m in models)
    R = 1000
    ro, rd, vd, _ = _rays(R, 1, cuda_device)
    ro = ro + torch.tensor([0.0, 0.0, 4.0], device=cuda_device)
    common = dict(mlp=cfg, n_samples=64, n_importance=128, perturb=False,
                  white_bkgd=True)
    render = lambda **kw: renderer.render_rays(
        *models, ro, rd, vd, 2.0, 6.0,
        renderer.RenderConfig(**common, **kw), deterministic=True)
    _build.reset_launch_counts()
    with torch.no_grad():
        want = render()
        assert not any(_build.launch_counts().values())
        got = render(use_fused_mlp=True, use_fused_compositing=True)
        assert _build.launch_counts()["render_pass_bf16"] == 2
        noisy = render(use_fused_mlp=True, use_fused_compositing=True,
                       raw_noise_std=1.0)
        counts = _build.launch_counts()
    assert counts["mlp_from_points_bf16"] == 2
    assert counts["render_pass"] == 0 and counts["mlp_from_points"] == 0
    for out in (got, noisy):
        assert float((out["rgb_map"] - want["rgb_map"]).abs().max()) < 5e-3
    # training renders: K-B1 bf16 with use_fused_train, coarse and fine, and
    # no kernel without it (the folded plain form)
    for fused in (False, True):
        _build.reset_launch_counts()
        out = renderer.render_rays(
            *models, ro, rd, vd, 2.0, 6.0,
            renderer.RenderConfig(**common, use_fused_train=fused),
            deterministic=False)
        (out["rgb_map"].sum() + out["rgb0"].sum()).backward()
        counts = _build.launch_counts()
        assert counts["mlp_train_fwd_bf16"] == counts["mlp_train_bwd_bf16"] \
            == (2 if fused else 0), counts
        assert sum(counts.values()) == (4 if fused else 0), counts


# K-B1 in bf16 (csrc/mlp_train_bf16.cu, and mlp_train_dw.cu's SIMT backward with
# dW in bf16) against its plain bf16 versions, in units of the distance
# between the plain bf16 and the plain float32 version on the same inputs:
# raw as K-B3 bf16 (_held_to_bf16_distance); each part of the gradient (dW,
# dls, db over all layers) rms <= 1/4 of the distance's rms and no element
# beyond 1/2 of its max, dW besides one bf16 step (2^-7 of the value: both
# round it once summed, and a last-bit difference of the float32 sum moves
# it by a step). Measured on an H100 at 196,608 points: raw 0.056 / 0.53,
# gradients 0.06-0.07 / 0.07-0.09; at 1,000 points up to 0.08 / 0.20.
def _grads_to_bf16_distance(flat, flat16, flat32, with_dw):
    parts = zip(("dW", "dls", "db"),
                *(mlp_train_fused.split_grads(f, with_dw)
                  for f in (flat, flat16, flat32)))
    for part, got, want16, want32 in parts:
        if got is None:
            continue
        got, want16, want32 = (torch.cat([v.reshape(-1) for v in d.values()])
                               for d in (got, want16, want32))
        err, dist = got - want16, want16 - want32
        step = 2.0 ** -7 * want16.abs() if part == "dW" else 0.0
        assert torch.isfinite(got).all(), part
        assert _rms(err) <= _rms(dist) / 4, (part, _rms(err), _rms(dist))
        assert float((err.abs() - step).max()) <= \
            float(dist.abs().max()) / 2, part


@pytest.mark.cuda
def test_cuda_train_bf16_build_and_sizes(cuda_device):
    sizes = [ctypes.c_int() for _ in range(3)]
    _build.lib().nnc_train_bf16_sizes(*(ctypes.byref(c) for c in sizes))
    assert [c.value for c in sizes] == [
        mlp_train_fused.TILE_BF16, mlp_fused.BF16_PARAMS_SIZE,
        mlp_train_fused.BWD_BF16_PARAMS_SIZE]


@pytest.mark.cuda
@pytest.mark.parametrize("n,with_dw", [(10_000, False), (10_000, True),
                                       (33, False), (16_401, True),
                                       (196_608, False)])
def test_cuda_mlp_train_bf16_matches_plain(cuda_device, n, with_dw):
    """K-B1 bf16 forward and backward against the plain bf16 versions; 33,
    10,000 and 16,401 are no multiples of the forward's 128-point tile or
    of the backward's 64-point one."""
    model = _fog_model(cuda_device)
    g = torch.Generator().manual_seed(6)
    pts = (4 * torch.rand(n, 3, generator=g) - 2).to(cuda_device)
    vd = torch.randn(n, 3, generator=g)
    vd = (vd / torch.linalg.norm(vd, dim=-1, keepdim=True)).to(cuda_device)
    cot = (1e-2 * torch.randn(n, 4, generator=g)).to(cuda_device)
    tensors = mlp_train_fused._layer_tensors(model)
    params, params_t, ls = mlp_train_fused.pack_train(
        tensors[0::3], tensors[1::3], tensors[2::3])
    fwd_b, bwd_b = mlp_train_fused.pack_train_bf16(tensors[0::3])
    biases = mlp_train_fused.gather_biases(params)
    before = _build.launch_counts()
    raw, ws = mlp_train_fused.mlp_train_fwd_bf16(params, ls, pts, vd,
                                                 save_u=True)
    flat = mlp_train_fused.mlp_train_bwd_bf16(params, params_t, ls, pts, vd,
                                              cot, ws, with_dw)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    bwd = "mlp_train_bwd_dw_bf16" if with_dw else "mlp_train_bwd_bf16"
    assert after["mlp_train_fwd_bf16"] == before["mlp_train_fwd_bf16"] + 1
    assert after[bwd] == before[bwd] + 1
    assert after["mlp_train_fwd"] == before["mlp_train_fwd"]
    assert after["mlp_train_bwd"] == before["mlp_train_bwd"]
    assert ws.shape == (-(-n // 128) * 128, mlp_train_fused.U_SIZE)
    assert torch.isfinite(ws).all()
    _held_to_bf16_distance(
        raw, mlp_train_fused.mlp_train_fwd_bf16_plain(params, ls, pts, vd),
        mlp_train_fused.mlp_train_fwd_plain(params, ls, pts, vd))
    raw0, none = mlp_train_fused.mlp_train_fwd_bf16(params, ls, pts, vd)
    assert none is None and torch.equal(raw0, raw)
    _grads_to_bf16_distance(
        flat, mlp_train_fused.mlp_train_bwd_bf16_plain(
            params, params_t, ls, pts, vd, cot, with_dw),
        mlp_train_fused.mlp_train_bwd_plain(params, params_t, ls, pts, vd,
                                            cot, with_dw), with_dw)
    if with_dw:
        dw = flat[:mlp_train_fused.WT_SIZE]
        assert torch.equal(dw, mlp_fused.bf16_round(dw))
    # reruns bit-equal, also from the cached buffers; with dW the du
    # workspace too (zeroed first: columns past the gradient's are not
    # written)
    again = mlp_train_fused.mlp_train_bwd_bf16(
        params, params_t, ls, pts, vd, cot, ws, with_dw, packed_bf16_t=bwd_b,
        biases=biases)
    assert torch.equal(again, flat)
    if with_dw:
        dus = [torch.zeros((ws.shape[0], mlp_train_fused.DU_COLS_BF16),
                           dtype=torch.bfloat16, device=cuda_device)
               for _ in range(2)]
        for du in dus:
            assert torch.equal(mlp_train_fused.mlp_train_bwd_bf16(
                params, params_t, ls, pts, vd, cot, ws, True, bwd_b, biases,
                du=du), flat)
        assert torch.equal(dus[0], dus[1])
    raw_c, ws_c = mlp_train_fused.mlp_train_fwd_bf16(
        None, ls, pts, vd, save_u=True, packed_bf16=fwd_b, biases=biases)
    assert torch.equal(raw_c, raw) and torch.equal(ws_c, ws)
    # the bf16 backward refuses the float32 forward's workspace shape
    if n % 128:
        with pytest.raises(ValueError):
            mlp_train_fused.mlp_train_bwd_bf16(
                params, params_t, ls, pts, vd, cot, ws[:-64], with_dw)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [33, 16_401, 196_608 + 5])
def test_cuda_mlp_train_fwd_bf16_workspace_matches_plain_u(cuda_device, n):
    """Every u that K-B1 bf16's forward stores (by TMA bulk stores in the
    256-wide layers, from the fragments in the view layer and the heads)
    lies where the backward reads it: the workspace's rows of the points
    against the plain bf16 chain's u, in units of the bf16-to-float32
    distance; rows past N hold finite values; a rerun writes the same bits,
    and the forward without the workspace the same raw."""
    model = _fog_model(cuda_device, seed=7)
    g = torch.Generator().manual_seed(8)
    pts = (4 * torch.rand(n, 3, generator=g) - 2).to(cuda_device)
    vd = torch.randn(n, 3, generator=g)
    vd = (vd / torch.linalg.norm(vd, dim=-1, keepdim=True)).to(cuda_device)
    tensors = mlp_train_fused._layer_tensors(model)
    params, params_t, ls = mlp_train_fused.pack_train(
        tensors[0::3], tensors[1::3], tensors[2::3])
    fwd_b, _bwd_b = mlp_train_fused.pack_train_bf16(tensors[0::3])
    biases = mlp_train_fused.gather_biases(params)
    raw, ws = mlp_train_fused.mlp_train_fwd_bf16(params, ls, pts, vd, True,
                                                 fwd_b, biases)
    torch.cuda.synchronize()
    assert ws.shape == (-(-n // mlp_train_fused.TILE_BF16)
                        * mlp_train_fused.TILE_BF16, mlp_train_fused.U_SIZE)
    assert torch.isfinite(ws).all()
    cot = torch.zeros(n, 4, device=cuda_device)
    ws16, _ = mlp_train_fused.train_workspaces_plain(
        params, params_t, ls, pts, vd, cot, bf16=True)
    ws32, _ = mlp_train_fused.train_workspaces_plain(
        params, params_t, ls, pts, vd, cot)
    _held_to_bf16_distance(ws[:n], ws16[:n], ws32[:n])
    raw2, ws2 = mlp_train_fused.mlp_train_fwd_bf16(params, ls, pts, vd, True,
                                                   fwd_b, biases)
    assert torch.equal(raw2, raw) and torch.equal(ws2, ws)
    raw0, none = mlp_train_fused.mlp_train_fwd_bf16(params, ls, pts, vd,
                                                    False, fwd_b, biases)
    assert none is None and torch.equal(raw0, raw)


@pytest.mark.cuda
def test_cuda_fused_train_bf16_autograd_and_cache(cuda_device):
    """fused_nerf_mlp_train of a bf16 model through autograd on the card:
    K-B1 bf16 only, the bf16 buffers from TRAIN_PACKS (a float32 model over
    the same tensors gets its own), gradients held to the plain bf16
    versions as above."""
    model = _fog_model(cuda_device)
    bf16_model = nerf.NeRF(nerf.NeRFConfig(compute_dtype=torch.bfloat16),
                           device=cuda_device)
    for src, dst in zip(model.layers().values(),
                        bf16_model.layers().values()):
        dst.weight, dst.bias = src.weight, src.bias
        dst.weight_scaling = src.weight_scaling
    pts, vd = _points(5000, cuda_device)
    cot = 1e-2 * torch.randn(5000, 4, device=cuda_device)
    for layer in bf16_model.layers().values():
        layer.weight_scaling.requires_grad_(True)
        layer.bias.requires_grad_(True)
    cache = mlp_train_fused.TRAIN_PACKS
    misses = cache.misses
    _build.reset_launch_counts()
    raw = mlp_train_fused.fused_nerf_mlp_train(bf16_model, pts, vd)
    raw.backward(cot)
    counts = _build.launch_counts()
    assert counts["mlp_train_fwd_bf16"] == counts["mlp_train_bwd_bf16"] == 1
    assert sum(counts.values()) == 2
    with torch.no_grad():
        mlp_train_fused.fused_nerf_mlp_train(model, pts, vd)
    assert cache.misses == misses + 2
    tensors = mlp_train_fused._layer_tensors(bf16_model)
    params, params_t, ls = mlp_train_fused.pack_train(
        tensors[0::3], tensors[1::3], tensors[2::3])
    layers = bf16_model.layers().values()
    got = torch.cat([torch.cat([x.weight_scaling.grad.reshape(-1)
                                for x in layers]),
                     torch.cat([x.bias.grad for x in layers])])
    _grads_to_bf16_distance(
        got, mlp_train_fused.mlp_train_bwd_bf16_plain(
            params, params_t, ls, pts, vd, cot, False),
        mlp_train_fused.mlp_train_bwd_plain(params, params_t, ls, pts, vd,
                                            cot, False), False)
    for layer in bf16_model.layers().values():
        for t in (layer.weight_scaling, layer.bias):
            t.requires_grad_(False)
            t.grad = None


# --- K-B5 and K-B6 in bf16 -----------------------------------------------------
# Held to the distance between the plain bf16 and the plain float32 version on
# the same inputs, as K-B3 bf16 (_held_to_bf16_distance).
def _bf16_twin(model):
    """A bf16 model over the same weight, bias and scale tensors."""
    twin = nerf.NeRF(nerf.NeRFConfig(compute_dtype=torch.bfloat16),
                     device=next(model.parameters()).device)
    for src, dst in zip(model.layers().values(), twin.layers().values()):
        dst.weight, dst.bias = src.weight, src.bias
        dst.weight_scaling = src.weight_scaling
    return twin


@pytest.mark.cuda
@pytest.mark.parametrize("n", [33, 64, 10_000, 10_001, 3_414_016])
def test_cuda_mlp_embedded_bf16_matches_plain(cuda_device, n):
    """K-B5 bf16 against its plain bf16 version, against K-B3 bf16 on the
    points the embeddings were made of, and through fused_nerf_mlp."""
    model = _fog_model(cuda_device)
    pts, vd = _points(n, cuda_device)
    pe = positional_encoding(pts, 10).contiguous()
    ve = positional_encoding(vd, 4).contiguous()
    packed = mlp_fused.pack_weights(model)
    buf = mlp_fused.pack_weights_bf16(model)
    before = _build.launch_counts()
    got = mlp_fused.mlp_embedded_bf16(buf, pe, ve)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert after["mlp_embedded_bf16"] == before["mlp_embedded_bf16"] + 1
    assert after["mlp_embedded"] == before["mlp_embedded"]
    assert got.shape == (n, 4) and torch.isfinite(got).all()
    plain32 = mlp_fused.fused_nerf_mlp_plain(packed, pe, ve)
    _held_to_bf16_distance(
        got, mlp_fused.fused_nerf_mlp_bf16_plain(buf, pe, ve), plain32)
    # K-B3 bf16 computes the same embedding with sincosf: the two differ
    # where a last-bit difference of an embedding value flips its rounding
    _held_to_bf16_distance(got, mlp_fused.mlp_from_points_bf16(buf, pts, vd),
                           plain32)
    assert torch.equal(mlp_fused.mlp_embedded_bf16(buf, pe, ve), got)
    with torch.no_grad():
        via = mlp_fused.fused_nerf_mlp(_bf16_twin(model), pe[None], ve[None])
    assert via.shape == (1, n, 4) and torch.equal(via[0], got)
    assert _build.launch_counts()["mlp_embedded"] == before["mlp_embedded"]


@pytest.mark.cuda
def test_cuda_mlp_embedded_bf16_needs_aligned_embeddings(cuda_device):
    """The kernel copies a tile's rows as one bulk copy: a view that starts
    at a row that is a multiple of 4 runs (and gives the values of a copy
    of it), one that does not is refused."""
    model = _fog_model(cuda_device)
    pts, vd = _points(1_000, cuda_device)
    pe = positional_encoding(pts, 10).contiguous()
    ve = positional_encoding(vd, 4).contiguous()
    buf = mlp_fused.pack_weights_bf16(model)
    assert torch.equal(
        mlp_fused.mlp_embedded_bf16(buf, pe[4:], ve[4:]),
        mlp_fused.mlp_embedded_bf16(buf, pe[4:].clone(), ve[4:].clone()))
    for a, b in ((pe[1:], ve[4:-3]), (pe[4:-3], ve[1:])):
        with pytest.raises(ValueError, match="aligned"):
            mlp_fused.mlp_embedded_bf16(buf, a, b)


@pytest.mark.cuda
def test_cuda_fused_nerf_mlp_bf16_any_alignment(cuda_device):
    """The model-level entry takes the views the float32 route takes: one
    that starts at a row that is not a multiple of 4 is copied before the
    bf16 kernel, and gives the values of an aligned copy of it."""
    twin = _bf16_twin(_fog_model(cuda_device))
    pts, vd = _points(1_000, cuda_device)
    pe = positional_encoding(pts, 10).contiguous()
    ve = positional_encoding(vd, 4).contiguous()
    for a, b in ((pe[1:], ve[:-1]), (pe[:-1], ve[1:]), (pe[3:], ve[3:])):
        assert torch.equal(mlp_fused.fused_nerf_mlp(twin, a, b),
                           mlp_fused.fused_nerf_mlp(twin, a.clone(),
                                                    b.clone()))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [262_144, 10_001])
@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_cuda_mlp_tp_pair_bf16_matches_plain(cuda_device, m, n):
    """K-B6 bf16 at every (K, S, O2, relu_mid) the forward uses with M
    shards, against its plain bf16 version and the float32 pair of the
    unrounded weights."""
    g = torch.Generator().manual_seed(9)
    s = 256 // m
    for k, o2, relu_mid in PAIR_HEADS:
        x = torch.randn(n, k, generator=g).to(cuda_device)
        wa = (torch.randn(k, s, generator=g) / k ** 0.5).to(cuda_device)
        ba = torch.randn(s, generator=g).to(cuda_device)
        wb = (torch.randn(s, o2, generator=g) / s ** 0.5).to(cuda_device)
        args = (x, wa.bfloat16(), ba, wb.bfloat16(), relu_mid)
        before = _build.launch_counts()
        got = mlp_tp_fused.fused_pair_bf16(*args)
        torch.cuda.synchronize()
        after = _build.launch_counts()
        assert after["mlp_tp_pair_bf16"] == before["mlp_tp_pair_bf16"] + 1
        assert after["mlp_tp_pair"] == before["mlp_tp_pair"]
        assert got.shape == (n, o2) and torch.isfinite(got).all()
        _held_to_bf16_distance(
            got, mlp_tp_fused.fused_pair_bf16_plain(*args),
            mlp_tp_fused.fused_pair_plain(x, wa, ba, wb, relu_mid))
        assert torch.equal(mlp_tp_fused.fused_pair_bf16(*args), got)
    with pytest.raises(ValueError, match="no kernel"):
        mlp_tp_fused.fused_pair_bf16(x, args[1], ba, args[3], True)
    with pytest.raises(ValueError, match="aligned"):
        shifted = torch.cat([args[3].reshape(-1).new_zeros(1),
                             args[3].reshape(-1)])[1:].reshape(s, o2)
        mlp_tp_fused.fused_pair_bf16(x, args[1], ba, shifted, relu_mid)
    with pytest.raises(ValueError, match="aligned"):   # K = 256: float4 loads
        shifted = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].reshape(n, k)
        mlp_tp_fused.fused_pair_bf16(shifted, *args[1:])
    with pytest.raises(ValueError, match="bfloat16"):
        mlp_tp_fused.fused_pair_bf16(x, wa, ba, wb, relu_mid)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_cuda_fused_nerf_mlp_tp_bf16_matches_dense(cuda_device, m):
    """The bf16 tensor-parallel forward on a mesh of M x cuda:0: 5 launches
    of K-B6 bf16 per shard and none of the float32 kernel, the result against
    the dense plain bf16 MLP and against K-B5 bf16."""
    model = _fog_model(cuda_device)
    twin = _bf16_twin(model)
    n = 20_001
    pts, vd = _points(n, cuda_device)
    pe = positional_encoding(pts, 10).contiguous()
    ve = positional_encoding(vd, 4).contiguous()
    mesh = parallel.make_mesh(m, ("model",))
    _build.reset_launch_counts()
    with torch.no_grad():
        got = mlp_tp_fused.fused_nerf_mlp_tp(twin, pe, ve, mesh)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        assert counts["mlp_tp_pair_bf16"] == 5 * m
        assert counts["mlp_tp_pair"] == 0
        dense16 = nerf.apply_mlp(twin, pe, ve)
        dense32 = nerf.apply_mlp(model, pe, ve)
        kb5 = mlp_fused.fused_nerf_mlp(twin, pe, ve)
    for want in (dense16, kb5):
        _held_to_bf16_distance(got, want, dense32)
    with torch.no_grad():
        assert torch.equal(mlp_tp_fused.fused_nerf_mlp_tp(twin, pe, ve, mesh),
                           got)


# occupancy mode (render/occupancy.py): the grid swept through K-B3, compacted
# rays through K-B2, the occupancy LSA loss through K-B1. Each against the
# same work through the plain versions, swapped in on the CUDA tensors; the
# grid may differ only at a threshold tie (|d sigma| within K-B3's 3e-5, or
# in bf16 within the sweep's bf16-to-float32 distance), the maps and the
# gradients by the bars above.
def _plain_kb3(monkeypatch):
    for name, plain in (
            ("mlp_from_points", mlp_fused.fused_nerf_mlp_from_points_plain),
            ("mlp_from_points_bf16",
             mlp_fused.fused_nerf_mlp_from_points_bf16_plain)):
        monkeypatch.setattr(mlp_fused, name,
                            lambda packed, pts, dirs, _p=plain, **_kw:
                            _p(packed, pts, dirs))


def _sigma(model, res):
    axes = (torch.arange(res, dtype=torch.float32) + 0.5) * 4.0 / res - 2.0
    pts = torch.stack(torch.meshgrid(axes, axes, axes, indexing="ij"),
                      -1).reshape(-1, 3).to(model.device)
    vd = torch.zeros_like(pts)
    vd[:, 2] = 1.0
    return torch.relu(mlp_fused.fused_nerf_mlp_from_points(model, pts,
                                                           vd)[:, 3])


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_cuda_occupancy_grid_matches_plain(cuda_device, bf16, monkeypatch):
    """The solid teacher without weight noise (noise on its weights leaks
    density through the whole box)."""
    from nnc_tpu_torch.render import occupancy
    model = synthetic.make_solid_mlp(device=cuda_device)
    twin = _bf16_twin(model) if bf16 else model
    res = 64
    before = _build.launch_counts()
    grid = occupancy.build_occupancy_grid(twin, res=res, chunk=65_536)
    name = "mlp_from_points_bf16" if bf16 else "mlp_from_points"
    assert _build.launch_counts()[name] == before[name] + 4
    sig_k = _sigma(twin, res)
    with monkeypatch.context() as mp:
        _plain_kb3(mp)
        grid_p = occupancy.build_occupancy_grid(twin, res=res, chunk=65_536)
        sig_p = _sigma(twin, res)
        tol = float((sig_p - _sigma(model, res)).abs().max()) if bf16 \
            else 3e-5
    assert _build.launch_counts()[name] == before[name] + 5
    d0 = ((sig_k > 1e-2) != (sig_p > 1e-2)).reshape(res, res, res)
    if d0.any():
        assert float((sig_k - sig_p).abs().reshape(d0.shape)[d0].max()) \
            <= tol
    assert not ((grid.occ != grid_p.occ) & ~occupancy._dilate(d0, 3)).any()
    assert (grid.occ_lo, grid.open_boundary) == \
        (grid_p.occ_lo, grid_p.open_boundary)
    assert 0.01 < float(grid.occ.float().mean()) < 0.5


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("layout", [None, (64, 64)], ids=["per_ray", "tiled"])
def test_cuda_occupancy_render_matches_plain(cuda_device, bf16, layout,
                                             monkeypatch):
    """16 compacted samples a ray, zero-dist tails, rays sorted by their
    occupied count: K-B2 against its plain version on the same selection
    (in float32 the packed render pass, bf16 the ray queue). The grid is
    the solid teacher's; the weights rendered carry noise, so that every
    product is dense."""
    from nnc_tpu_torch.render import occupancy
    from nnc_tpu_torch.render.rays import get_rays_np
    model = synthetic.make_solid_mlp(noise_std=1e-3, device=cuda_device,
                                     generator=torch.Generator()
                                     .manual_seed(7))
    twin = _bf16_twin(model) if bf16 else model
    grid = occupancy.build_occupancy_grid(
        synthetic.make_solid_mlp(device=cuda_device), res=64)
    K = torch.tensor([[51.2, 0, 32], [0, 51.2, 32], [0, 0, 1]]).numpy()
    ro, rd = (torch.as_tensor(a.reshape(-1, 3), device=cuda_device)
              for a in get_rays_np(64, 64, K, synthetic.look_at_poses(1)[0]
                                   [:3, :4]))
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    rc = lambda m: renderer.RenderConfig(mlp=m.config, white_bkgd=True)
    run = lambda m: occupancy.render_rays_fast(
        m, ro, rd, vd, 2.0, 6.0, grid, rc(m), layout=layout)
    name = "render_pass_bf16" if bf16 else "render_pass_packed"
    before = _build.launch_counts()[name]
    calls = []
    with monkeypatch.context() as mp:
        real = getattr(render_fused, name)
        mp.setattr(render_fused, name, lambda *a, **kw: (
            calls.append((a, kw)), real(*a, **kw))[1])
        got = run(twin)
    assert _build.launch_counts()[name] == before + 1
    with monkeypatch.context() as mp:
        mp.setattr(render_fused, "render_pass_packed",
                   lambda packed, *a, packed_mma=None, **kw:
                   render_fused.fused_render_pass_packed_plain(packed, *a,
                                                               **kw))
        mp.setattr(render_fused, "render_pass_bf16",
                   render_fused.fused_render_pass_bf16_plain)
        want = run(twin)
        want32 = run(model) if bf16 else None
    assert _build.launch_counts()[name] == before + 1
    acc = got["acc_map"]
    assert 0.05 < float((acc > 0.5).float().mean()) < 0.95
    if bf16:
        for k in ("rgb_map", "acc_map"):
            _held_to_bf16_distance(got[k], want[k], want32[k])
    else:
        # the frame, as before: early termination is on (1e-4), 2 eps, depth
        # 20 eps
        eps = rc(model).early_term_eps
        for k in ("rgb_map", "acc_map"):
            assert float((got[k] - want[k]).abs().max()) <= 2 * eps, k
        assert float((got["depth_map"] - want["depth_map"]).abs().max()) \
            <= 20 * eps
        _compacted_launch_within_its_mlp_error(*calls[0], eps)
    assert all(torch.equal(run(twin)[k], got[k]) for k in got)


def _compacted_launch_within_its_mlp_error(args, kw, eps):
    """K-B2 float32 on a compacted launch (the packed render pass) against
    its plain version, ray by ray, with the bar stated from where the two
    part. The rays carry at most
    SAMPLE_BLOCK samples, one block, whose start is always computed, so
    early termination cannot act: the two part only through the MLP. The
    solid teacher's density reaches ~150 and a sample's sigma * dist ~33, so
    the 3xTF32 products' ~2e-6 relative error in sigma (3e-4 absolute)
    shows in the maps. K-B2's chain is K-B3's: the plain compositing of
    K-B3's raw on the launch's points gives the kernel's maps within the
    bars of early termination off (1e-5, depth 1e-4; 4.8e-7 measured on an
    H100). And with E = sum over a ray's samples of dist * |d sigma| and dc
    its largest |d colour| between K-B3 and the plain MLP, the first-order
    propagation bounds each ray: acc by 1e-5 + E, rgb by 1e-5 + 2 E + dc,
    depth by 1e-4 + 2 E z_max (measured at most 0.79 E, 0.51 E and 3.1 E on
    the rays beyond 1e-5), each capped at the frame's 2 eps (depth 20
    eps)."""
    packed, ro, rd, vd, z, dists = args[:6]
    R, S = z.shape
    assert S <= render_fused.SAMPLE_BLOCK
    maps = render_fused.render_pass_packed(*args, **kw)
    plain = render_fused.fused_render_pass_plain(*args)[0]
    kb3 = lambda p, pts, d: mlp_fused.mlp_from_points(p, pts, d,
                                                      kw["packed_mma"])
    mixed = render_fused.fused_render_pass_plain(*args, mlp_plain=kb3)[0]
    assert float((maps - mixed)[:, :4].abs().max()) <= 1e-5
    assert float((maps - mixed)[:, 4].abs().max()) <= 1e-4
    pts = (ro[:, None] + rd[:, None] * z[..., None]).reshape(-1, 3)
    dirs = vd[:, None].expand(R, S, 3).reshape(-1, 3).contiguous()
    raw_k = kb3(packed, pts, dirs).reshape(R, S, 4)
    raw_p = mlp_fused.fused_nerf_mlp_from_points_plain(
        packed, pts, dirs).reshape(R, S, 4)
    E = (dists * (torch.relu(raw_k[..., 3])
                  - torch.relu(raw_p[..., 3])).abs()).sum(dim=-1)
    dc = (torch.sigmoid(raw_k[..., :3])
          - torch.sigmoid(raw_p[..., :3])).abs().amax(dim=(1, 2))
    d = (maps - plain).abs()
    assert bool((d[:, :3].amax(dim=1)
                 <= torch.clamp(1e-5 + 2 * E + dc, max=2 * eps)).all())
    assert bool((d[:, 3] <= torch.clamp(1e-5 + E, max=2 * eps)).all())
    assert bool((d[:, 4] <= torch.clamp(1e-4 + 2 * E * z.amax(dim=1),
                                        max=20 * eps)).all())


def _packed_launch(device, budget, layout):
    """Occupancy mode's packed render pass on a 64x64 frame of the solid
    teacher's grid at ``budget``: the recorded launch's (args, kw), with the
    noisy solid's weights (every product dense)."""
    from nnc_tpu_torch.render import occupancy
    from nnc_tpu_torch.render.rays import get_rays_np
    model = synthetic.make_solid_mlp(noise_std=1e-3, device=device,
                                     generator=torch.Generator()
                                     .manual_seed(7))
    grid = occupancy.build_occupancy_grid(
        synthetic.make_solid_mlp(device=device), res=64)
    K = torch.tensor([[51.2, 0, 32], [0, 51.2, 32], [0, 0, 1]]).numpy()
    ro, rd = (torch.as_tensor(a.reshape(-1, 3), device=device)
              for a in get_rays_np(64, 64, K, synthetic.look_at_poses(1)[0]
                                   [:3, :4]))
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    rc = renderer.RenderConfig(mlp=model.config, white_bkgd=True)
    calls = []
    real = render_fused.render_pass_packed
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(render_fused, "render_pass_packed", lambda *a, **kw: (
            calls.append((a, kw)), real(*a, **kw))[1])
        occupancy.render_rays_fast(model, ro, rd, vd, 2.0, 6.0, grid, rc,
                                   n_candidates=48, budget=budget,
                                   layout=layout)
    assert len(calls) == 1
    return calls[0]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [None, (64, 64)], ids=["per_ray",
                                                          "tiled"])
@pytest.mark.parametrize("budget", [1, 16, 32])
def test_cuda_packed_render_pass_equals_render_pass(cuda_device, budget,
                                                    layout):
    """The packed render pass on occupancy mode's own compacted launch
    against render_pass_kernel on the same inputs: the maps bit for bit (a
    point's MLP row depends on its inputs alone, each filled slot keeps its
    lane, the lanes past a ray's count add exact zeros); reruns bit-equal;
    rays without a filled slot and culled rays exact zeros; the stats the
    plan's."""
    args, kw = _packed_launch(cuda_device, budget, layout)
    args = args[:8]
    packed, ro, rd, vd, z, dists, live, term = args
    pm = kw["packed_mma"]
    stats = torch.full((2,), -1, dtype=torch.int64, device=cuda_device)
    before = _build.launch_counts()["render_pass_packed"]
    maps = render_fused.render_pass_packed(*args, stats=stats,
                                           packed_mma=pm)
    torch.cuda.synchronize()
    assert _build.launch_counts()["render_pass_packed"] == before + 1
    want = render_fused.render_pass(*args, want_weights=False,
                                    packed_mma=pm)[0]
    assert torch.equal(maps, want)
    assert torch.equal(render_fused.render_pass_packed(*args), maps)
    counts = render_fused.filled_counts(dists, live, term)
    empty = counts == 0
    assert int(empty.sum()) > 0 and bool((live[empty] == 0).any())
    assert bool((maps[empty] == 0).all())
    assert float(maps[:, 3].max()) > 0.5
    tiles = render_fused.packed_plan(render_fused.packed_bounds(
        counts, z.shape[1]))
    assert stats.tolist() == [int(counts.sum()),
                              render_fused.PACKED_POINTS * len(tiles)]
    assert int(counts.sum()) > 0.8 * stats.tolist()[1]


@pytest.mark.cuda
def test_cuda_frame_path_does_not_synchronise(cuda_device):
    """The frame path on rays already on the card, selection to the packed
    render pass and the maps' gather, under torch's sync debug mode set to
    raise: nothing in it waits for the card (the frame's one wait is
    render_image_fast's copy to the host)."""
    from nnc_tpu_torch.render import occupancy
    from nnc_tpu_torch.render.rays import get_rays_np
    model = synthetic.make_solid_mlp(device=cuda_device)
    grid = occupancy.build_occupancy_grid(model, res=64)
    K = torch.tensor([[51.2, 0, 32], [0, 51.2, 32], [0, 0, 1]]).numpy()
    ro, rd = (torch.as_tensor(a.reshape(-1, 3), device=cuda_device)
              for a in get_rays_np(64, 64, K, synthetic.look_at_poses(1)[0]
                                   [:3, :4]))
    vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    rc = renderer.RenderConfig(mlp=model.config, white_bkgd=True)
    run = lambda: occupancy.render_rays_fast(model, ro, rd, vd, 2.0, 6.0,
                                             grid, rc, layout=(64, 64))
    want = run()   # builds and packs first
    before = _build.launch_counts()["render_pass_packed"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert _build.launch_counts()["render_pass_packed"] == before + 1
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.cuda
def test_cuda_packed_render_pass_marks_rays_out_of_order(cuda_device):
    """Filled counts [1, 2, 0]: the plan's binary search puts rays 0 and 1
    in the run of count 2, where ray 0 does not belong: its maps are NaN,
    ray 1's are the render pass's, ray 2's zeros."""
    model = synthetic.make_solid_mlp(device=cuda_device)
    packed = mlp_fused.pack_weights(model)
    ro, rd, vd, _ = _rays(3, 2, cuda_device)
    ro = ro + torch.tensor([0.0, 0.0, 4.0], device=cuda_device)
    z = torch.tensor([[3.5, 4.0]] * 3, device=cuda_device)   # in the solid
    dists = torch.tensor([[0.1, 0.0], [0.1, 0.1], [0.0, 0.0]],
                         device=cuda_device)
    live = torch.ones(3, dtype=torch.int32, device=cuda_device)
    args = (packed, ro, rd, vd, z, dists, live, math.inf)
    maps = render_fused.render_pass_packed(*args)
    want = render_fused.render_pass(*args, want_weights=False)[0]
    assert bool(torch.isnan(maps[0]).all())
    assert torch.equal(maps[1], want[1]) and float(maps[1, 3]) > 0.5
    assert bool((maps[2] == 0).all())


@pytest.mark.cuda
def test_cuda_frame_span_counts_are_the_plans(cuda_device):
    """A traced 400x400 frame of the solid teacher through the packed
    render pass: its kb2 span's slots and points equal the plan of its own
    launch, read at the frame's wait."""
    from nnc_tpu_torch.render import occupancy
    from nnc_tpu_torch.render.rays import get_rays_np
    from nnc_tpu_torch.utils import profiling
    model = synthetic.make_solid_mlp(noise_std=1e-3, device=cuda_device,
                                     generator=torch.Generator()
                                     .manual_seed(7))
    grid = occupancy.build_occupancy_grid(model)
    K = torch.tensor([[555.6, 0, 200], [0, 555.6, 200], [0, 0, 1]]).numpy()
    ro, rd = get_rays_np(400, 400, K, synthetic.look_at_poses(1)[0][:3, :4])
    rc = renderer.RenderConfig(mlp=model.config, white_bkgd=True)
    calls = []
    real = render_fused.render_pass_packed
    with pytest.MonkeyPatch.context() as mp, profiling.trace_if(None):
        mp.setattr(render_fused, "render_pass_packed", lambda *a, **kw: (
            calls.append(a), real(*a, **kw))[1])
        occupancy.render_image_fast(model, ro, rd, 2.0, 6.0, rc, grid)
    (args,) = calls
    kb2 = [s for s in profiling.spans() if s.name == "nnc.frame.kb2"][-1]
    counts = render_fused.filled_counts(args[5], args[6], args[7])
    tiles = render_fused.packed_plan(render_fused.packed_bounds(counts, 16))
    assert kb2.counts == {"slots": int(counts.sum()),
                          "points": render_fused.PACKED_POINTS * len(tiles)}


@pytest.mark.cuda
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_cuda_occupancy_loss_kb1_matches_plain(cuda_device, bf16):
    """double_mse_loss_occ through K-B1 (use_fused_train) against the same
    loss through K-B1's plain versions on the same selected points: the loss
    and the scale gradients of both networks."""
    import contextlib

    from nnc_tpu_torch.render import occupancy
    from nnc_tpu_torch.train import lsa
    grid = occupancy.build_occupancy_grid(
        synthetic.make_solid_mlp(device=cuda_device), res=64, dilate=1)
    g = torch.Generator().manual_seed(8)
    R = 1024
    ro = (0.1 * torch.randn(R, 3, generator=g)
          + torch.tensor([0.0, 0.0, 4.0])).to(cuda_device)
    rd = (0.2 * torch.randn(R, 3, generator=g)
          + torch.tensor([0.0, 0.0, -1.0])).to(cuda_device)
    tgt = torch.rand(R, 3, generator=g).to(cuda_device)
    rc = renderer.RenderConfig(
        mlp=nerf.NeRFConfig(compute_dtype=torch.bfloat16 if bf16
                            else torch.float32),
        white_bkgd=True, use_fused_train=True)
    names = ("mlp_train_fwd_bf16", "mlp_train_bwd_bf16") if bf16 \
        else ("mlp_train_fwd", "mlp_train_bwd")

    def grads(plain):
        models = [_fog_model(cuda_device, seed=s) for s in (1, 2)]
        models = [_bf16_twin(m) if bf16 else m for m in models]
        lsa.trained_tensors(*models)
        stack = contextlib.ExitStack()
        if plain:
            mp = stack.enter_context(pytest.MonkeyPatch.context())
            mp.setattr(mlp_train_fused, "TRAIN_PACKS",
                       type("NoPacks", (), {"get": lambda *a: None})())
            mp.setattr(mlp_train_fused, "_fwd",
                       lambda bf, params, ls, pts, dirs, *a:
                       (mlp_train_fused._FORMS[bf]["fwd_plain"](
                           params, ls, pts, dirs), None))
            mp.setattr(mlp_train_fused, "_bwd",
                       lambda bf, params, params_t, ls, pts, dirs, g_, ws,
                       with_dw, *a: mlp_train_fused._FORMS[bf]["bwd_plain"](
                           params, params_t, ls, pts, dirs, g_, with_dw))
        with stack:
            before = _build.launch_counts()
            loss, _img = lsa.double_mse_loss_occ(*models, ro, rd, None, tgt,
                                                 2.0, 6.0, rc, grid)
            loss.backward()
            launched = {k: _build.launch_counts()[k] - before[k]
                        for k in names}
        flat = torch.cat([layer.weight_scaling.grad.reshape(-1)
                          for m in models for layer in m.layers().values()])
        return float(loss), flat, launched

    loss_k, flat_k, launched_k = grads(False)
    loss_p, flat_p, launched_p = grads(True)
    assert launched_k == {k: 2 for k in names}
    assert launched_p == {k: 0 for k in names}
    assert abs(loss_k - loss_p) <= 1e-4 * abs(loss_p)
    _grads_close(flat_k, flat_p, "scale gradients")


@pytest.mark.cuda
@pytest.mark.parametrize("loss", ["exact", "occupancy"])
@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
def test_cuda_lsa_graph_call_equals_eager_call(cuda_device, bf16, loss):
    """Three calls of 8 LSA steps through K-B1 (flagship width, 256 rays,
    16 + 16 samples or 32 selected on an occupancy grid): the replays of the
    CUDA graph that captured the 8 steps against the same calls run
    eagerly, bit for bit in the losses, the scales and Adam's moments; the
    graph's launches counted on every replay, plus its warm-up step."""
    from nnc_tpu_torch.render import occupancy
    from nnc_tpu_torch.train import lsa
    R, K = 256, 8
    rc = renderer.RenderConfig(
        mlp=nerf.NeRFConfig(compute_dtype=torch.bfloat16 if bf16
                            else torch.float32),
        n_samples=16, n_importance=16, raw_noise_std=0.5,
        use_fused_train=True)
    names = ("mlp_train_fwd_bf16", "mlp_train_bwd_bf16") if bf16 \
        else ("mlp_train_fwd", "mlp_train_bwd")
    grid = occupancy.build_occupancy_grid(
        synthetic.make_solid_mlp(device=cuda_device), res=64, dilate=1)
    route = lsa.route(rc, grid if loss == "occupancy" else None)
    runs = []
    for graph in (True, False):
        models = [_fog_model(cuda_device, seed=s) for s in (1, 2)]
        models = [_bf16_twin(m) if bf16 else m for m in models]
        adam = lsa.Adam(lsa.trained_tensors(*models))
        step = lsa.make_train_step(*models, rc, 2.0, 6.0, adam, route.loss)
        call = lsa.ScanTrainStep(step, adam, K, R, cuda_device, graph=graph)
        g = torch.Generator().manual_seed(3)
        dg = torch.Generator(device=cuda_device).manual_seed(4)
        before = _build.launch_counts()
        losses = []
        for c in range(3):
            batches = []
            for _ in range(K):
                ro = 0.1 * torch.randn(R, 3, generator=g) \
                    + torch.tensor([0.0, 0.0, 4.0])
                rd = 0.2 * torch.randn(R, 3, generator=g) \
                    + torch.tensor([0.0, 0.0, -1.0])
                vd = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
                tgt = torch.rand(R, 3, generator=g)
                batches.append(torch.cat([ro, rd, vd, tgt], -1).numpy())
            draws = [route.draws(R, dg, cuda_device) for _ in range(K)]
            host = lsa.pack_call(batches, [lsa.Adam.hyper(1e-3, K * c + j)
                                           for j in range(K)])
            losses.append(torch.from_numpy(call(host, draws)))
        launched = {k: _build.launch_counts()[k] - before[k] for k in names}
        runs.append((torch.cat(losses), torch.cat(
            [t.detach().reshape(-1) for t in adam.trained]),
            adam.m.clone(), adam.v.clone(), launched, call))
    (*got, launched_g, call_g), (*want, launched_e, _c) = runs
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())
    assert call_g.replays == 3 and call_g.captured == {k: 2 * K
                                                       for k in names}
    assert launched_e == {k: 2 * 3 * K for k in names}
    assert launched_g == {k: 2 * (3 * K + lsa.WARMUP_STEPS) for k in names}
    assert bool(torch.isfinite(got[0]).all()) and call_g.pool_bytes > 0


@pytest.mark.parametrize("n,c,relu", [(65536, 1024, True),
                                      (131072, 256, False),
                                      (65536, 3, False), (65536, 1, True),
                                      (1000, 128, True)])
def test_kb7_epilogue_against_plain(cuda_device, n, c, relu):
    from nnc_tpu_torch.ops import lsa_epilogue
    g = torch.Generator(device=cuda_device).manual_seed(n + c)
    r = lambda *shape: torch.randn(*shape, generator=g, device=cuda_device)
    acc, dy, s, b = r(n, c), r(n, c), 1 + 0.1 * r(c), 0.1 * r(c)
    y = lsa_epilogue.epilogue_fwd(acc, s, b, relu)
    torch.testing.assert_close(
        y, lsa_epilogue.epilogue_fwd_plain(acc, s, b, relu),
        rtol=2e-6, atol=2e-6)
    got = lsa_epilogue.epilogue_bwd(dy, acc, s, b, relu)
    again = lsa_epilogue.epilogue_bwd(dy, acc, s, b, relu)
    want = lsa_epilogue.epilogue_bwd_plain(dy, acc, s, b, relu)
    torch.testing.assert_close(got[0], want[0], rtol=2e-6, atol=2e-6)
    mask = (acc * s + b > 0) if relu else torch.ones_like(acc, dtype=bool)
    for k, scale in ((1, (dy * acc * mask).abs().sum(0)),
                     (2, (dy * mask).abs().sum(0))):
        assert bool(((got[k] - want[k]).abs() <= 1e-5 * scale + 1e-6).all())
    for a, b_ in zip(got, again):
        assert torch.equal(a, b_)
    _, ds, db = lsa_epilogue.epilogue_bwd(dy, acc.clone(), s, b, relu,
                                          want_dacc=False)
    assert torch.equal(ds, got[1]) and torch.equal(db, got[2])
    over = acc.clone()
    dacc, _, _ = lsa_epilogue.epilogue_bwd(dy, over, s, b, relu,
                                           over_acc=True)
    assert dacc.data_ptr() == over.data_ptr() and torch.equal(dacc, got[0])


def test_kb7_scaled_linear_against_plain_autograd(cuda_device):
    """A skip layer (two inputs) through cuBLAS and K-B7 against the plain
    autograd of (x @ W^T) * s + b, TF32 off on both sides."""
    from nnc_tpu_torch.models.nerf import Linear
    from nnc_tpu_torch.ops import lsa_epilogue
    torch.manual_seed(0)
    layer = Linear(96, 64, device=cuda_device)
    with torch.no_grad():
        layer.weight.copy_(torch.randn(64, 96) / math.sqrt(96))
        layer.bias.copy_(0.1 * torch.randn(64))
    layer.weight.requires_grad_(False)
    layer.weight_scaling = (1 + 0.1 * torch.randn(64, 1, device=cuda_device)
                            ).requires_grad_(True)
    layer.bias.requires_grad_(True)
    xs = [torch.randn(4096, k, device=cuda_device, requires_grad=True)
          for k in (64, 32)]
    cot = torch.randn(4096, 64, device=cuda_device)
    y = lsa_epilogue.scaled_linear(layer, xs, relu=True)
    got = torch.autograd.grad(y, [layer.weight_scaling, layer.bias, *xs],
                              cot)
    x = torch.cat([t.detach().requires_grad_(True) for t in xs], -1)
    s = layer.weight_scaling.detach().clone().requires_grad_(True)
    b = layer.bias.detach().clone().requires_grad_(True)
    want_y = torch.relu((x @ layer.weight.t()) * s.reshape(-1) + b)
    want = torch.autograd.grad(want_y, [s, b, x], cot)
    torch.testing.assert_close(y, want_y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got[0].reshape(-1), want[0].reshape(-1),
                               rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(torch.cat(got[2:], -1), want[2], rtol=1e-5,
                               atol=1e-5)
