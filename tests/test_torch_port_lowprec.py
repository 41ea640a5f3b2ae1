"""Kernels K-B4 (int8 MLP from points) and K-B5 (MLP on embedded input) of
nnc_tpu_torch, and the renderer routes that reach them.

On the CPU the wrappers run their plain PyTorch versions; those are held
against the JAX package's Pallas kernels run in interpret mode, at full
width, on inputs made from a numpy seed.

K-B5 (``fused_nerf_mlp``) vs ``mlp_pallas.fused_nerf_mlp``: rtol 1e-4, atol
1e-5 (float32 on both sides, sums in another order).

K-B4 (``fused_nerf_mlp_int8_from_points``): the weights' packing is the
reference's, integer for integer and scale for scale. The integer products
are exact on both sides, so with the reference's activation block (1,024
points, the input padded as it pads it) the outputs differ only where a
value sat within float rounding of a quantization tie: the reference's
in-kernel posenc takes cos(y) as sin(y + pi/2), which moves an embedding
value by up to ~3e-5, and a flipped tie moves a layer's input by one step of
m / 127. ``INT8_TIE_SHARE`` of the elements may differ by more than 1e-4 of
the output's scale (0.23% do at N = 2,048, and 73% are equal bit for bit);
none may differ by more than the reference's own bound against the float MLP
(tests/test_mlp_pallas.py:255). At the port's own block
(``INT8_ACT_BLOCK`` points) the output is held to that bound too.
The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_port_cuda.py.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nnc_tpu.data.synthetic import _activate
from nnc_tpu.models import nerf as jnerf
from nnc_tpu.ops import mlp_pallas
from nnc_tpu.ops.posenc import positional_encoding as jposenc
from nnc_tpu.render import renderer as jrenderer
from nnc_tpu_torch.models import nerf as tnerf
from nnc_tpu_torch.ops import _build, mlp_fused
from nnc_tpu_torch.render import renderer as trenderer

INT8_TIE_SHARE = 0.01


@pytest.fixture(scope="module")
def flagship():
    """Activated full-width weights (visible density), with LSA scales, as
    numpy, and the port's model of them."""
    cfg = jnerf.NeRFConfig()
    params = _activate(jnerf.init_params(jax.random.PRNGKey(0), cfg), 3)
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(8)
    ls = {name: (1.0 + 0.05 * rng.standard_normal(p["b"].shape[0]))
          .astype(np.float32) for name, p in params.items()}
    model = tnerf.from_jax_params(params, tnerf.NeRFConfig(), ls=ls)
    jparams = jax.tree.map(jnp.asarray, params)
    jls = {k: jnp.asarray(v) for k, v in ls.items()}
    return cfg, jparams, jls, model


def _points(n, seed):
    """Points in a lego-sized box and unit view directions."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    vd = rng.standard_normal((n, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    return pts, vd


def _int8_bound(ref):
    """tests/test_mlp_pallas.py:255."""
    return 0.05 * np.abs(ref).max() + 0.05


# ---------------------------------------------------------------- K-B5


@pytest.mark.parametrize("n", [33, 2048])
def test_fused_nerf_mlp_matches_pallas_interpret(flagship, n):
    """fused_nerf_mlp, whose float32 route passes packed_mma_for's buffer
    (None on the CPU), and the wrapper given the kernel's buffer."""
    cfg, jparams, jls, model = flagship
    rng = np.random.default_rng(n)
    pe = rng.standard_normal((n, 63)).astype(np.float32)
    ve = rng.standard_normal((n, 27)).astype(np.float32)
    want = np.asarray(mlp_pallas.fused_nerf_mlp(
        jparams, jls, jnp.asarray(pe), jnp.asarray(ve), cfg))
    before = _build.launch_counts()
    got = mlp_fused.fused_nerf_mlp(model, torch.from_numpy(pe),
                                   torch.from_numpy(ve))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    given = mlp_fused.mlp_embedded(
        mlp_fused.pack_weights(model), torch.from_numpy(pe),
        torch.from_numpy(ve), packed_mma=mlp_fused.pack_weights_mma(model))
    assert torch.equal(given, got)
    # CPU tensors take the plain version: no kernel launch is counted
    assert _build.launch_counts() == before


def test_fused_nerf_mlp_keeps_leading_shape_and_broadcast_views(flagship):
    """The renderer's call: (R, S, 63) points, a per-ray view embedding
    expanded over the samples (not contiguous)."""
    _cfg, _jparams, _jls, model = flagship
    g = torch.Generator().manual_seed(0)
    pe = torch.randn(5, 7, 63, generator=g)
    ve = torch.randn(5, 27, generator=g)[:, None, :].expand(5, 7, 27)
    got = mlp_fused.fused_nerf_mlp(model, pe, ve)
    want = tnerf.apply_mlp(model, pe, ve)
    assert got.shape == (5, 7, 4)
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(), rtol=1e-4,
                               atol=1e-5)


def test_fused_nerf_mlp_non_flagship_uses_plain_mlp():
    """W=32 has no kernel: the plain MLP answers, as in the reference
    (mlp_pallas.py:421-422)."""
    jcfg = jnerf.NeRFConfig(W=32)
    params = jax.tree.map(np.asarray,
                          jnerf.init_params(jax.random.PRNGKey(0), jcfg))
    model = tnerf.from_jax_params(params, tnerf.NeRFConfig(W=32))
    rng = np.random.default_rng(3)
    pe = rng.standard_normal((4, 63)).astype(np.float32)
    ve = rng.standard_normal((4, 27)).astype(np.float32)
    want = np.asarray(mlp_pallas.fused_nerf_mlp(
        jax.tree.map(jnp.asarray, params), None, jnp.asarray(pe),
        jnp.asarray(ve), jcfg))
    got = mlp_fused.fused_nerf_mlp(model, torch.from_numpy(pe),
                                   torch.from_numpy(ve))
    assert got.shape == (4, 4)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=1e-5)
    assert mlp_fused.fused_nerf_mlp_int8_from_points(
        model, torch.from_numpy(pe[:, :3]), torch.from_numpy(ve[:, :3])) \
        .shape == (4, 4)


# ---------------------------------------------------------------- K-B4


def _strip_tpu_padding(key, w):
    """A block of the TPU layout (128-row input blocks, 128-lane heads,
    mlp_pallas.py:63-80) cut back to the rows and columns that hold weights."""
    w = np.asarray(w)
    rows = {"w0": slice(0, 63), "w5a": slice(0, 63), "wvb": slice(64, 91)}
    cols = {"wa": slice(3, 4), "wr": slice(0, 3)}
    if w.shape[0] > 1:      # a weight block; a scale row has one row
        w = w[rows.get(key, slice(None))]
    return w[:, cols.get(key, slice(None))]


def test_pack_weights_int8_equals_reference(flagship):
    _cfg, jparams, jls, model = flagship
    wq_j, scales_j, biases_j = mlp_pallas._pack_weights_int8(jparams, jls)
    wq, scales, biases = mlp_fused.pack_weights_int8(model)
    assert wq.dtype == torch.int8 and wq.shape == (mlp_fused.INT8_WQ_SIZE,)
    W, B = mlp_fused.unpack_weights_int8(wq, scales, biases)
    assert list(W) == ["w0", "w1", "w2", "w3", "w4", "w5a", "w5b", "w6", "w7",
                       "wf", "wa", "wva", "wvb", "wr"]
    for key, (q, s) in W.items():
        want_q = _strip_tpu_padding(key, wq_j[key])
        want_s = _strip_tpu_padding(key, scales_j[key])[0]
        assert want_q.dtype == np.int8
        np.testing.assert_array_equal(q.numpy(), want_q, err_msg=key)
        np.testing.assert_array_equal(s.numpy(), want_s, err_msg=key)
        # what the padding held was zero: nothing was cut away
        assert np.abs(np.asarray(wq_j[key])).sum() == np.abs(want_q).sum()
    for key, b in B.items():
        want_b = np.asarray(biases_j[key])[0]
        want_b = {"ba": want_b[3:4], "br": want_b[:3]}.get(key, want_b)
        np.testing.assert_array_equal(b.numpy(), want_b, err_msg=key)


def test_pack_weights_int8_layout_and_zero_columns():
    """Four consecutive inputs of one output column share a 32-bit word; rows
    pad to a multiple of four; an all-zero column keeps scale 0 and zeros."""
    model = tnerf.init_params(tnerf.NeRFConfig(),
                              torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.layers()["pts_linears.1"].weight[5].zero_()   # output column 5
    wq, scales, biases = mlp_fused.pack_weights_int8(model)
    W, _B = mlp_fused.unpack_weights_int8(wq, scales, biases)
    q0, _s0 = W["w0"]
    words = wq[:16 * 256 * 4].view(16, 256, 4)     # block w0: 63 -> 64 rows
    for k, o in ((0, 0), (13, 77), (62, 255)):
        assert words[k // 4, o, k % 4] == q0[k, o]
    assert (words[15, :, 3] == 0).all()            # the padding row
    q1, s1 = W["w1"]
    assert s1[5] == 0 and (q1[:, 5] == 0).all()
    assert int(q1.abs().max()) == 127
    with pytest.raises(ValueError):
        mlp_fused.pack_weights_int8(tnerf.NeRF(tnerf.NeRFConfig(W=32)))


def _zero_column_model():
    """A model with an all-zero output column in pts_linears.1 and in the
    alpha head (scale 0, integers 0)."""
    model = tnerf.init_params(tnerf.NeRFConfig(),
                              torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.layers()["pts_linears.1"].weight[5].zero_()
        model.layers()["alpha_linear"].weight.zero_()
    return model


@pytest.mark.parametrize("which", ["flagship", "zero_column"])
def test_int8_mma_buffer_unpacks_to_pack_weights_int8(flagship, which):
    """The tensor-core kernel's buffer holds pack_weights_int8's integers,
    scales and biases and nothing else: read back, all three are equal bit
    for bit, the zero column's scale and integers included."""
    model = flagship[-1] if which == "flagship" else _zero_column_model()
    wq, scales, biases = mlp_fused.pack_weights_int8(model)
    buf = mlp_fused.pack_weights_int8_mma(model)
    assert buf.dtype == torch.int32 and buf.shape == (mlp_fused.INT8_MMA_SIZE,)
    back = mlp_fused.unpack_weights_int8_mma(buf)
    for got, want in zip(back, (wq, scales, biases)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    if which == "zero_column":
        W, _B = mlp_fused.unpack_weights_int8(*back)
        assert W["w1"][1][5] == 0 and (W["w1"][0][:, 5] == 0).all()
        assert (W["wa"][1] == 0).all() and (W["wa"][0] == 0).all()
    # every byte of the buffer past what it holds is zero
    n_used = mlp_fused._INT8_MMA_USED
    assert (buf[n_used:] == 0).all()
    pads = np.flatnonzero(mlp_fused.INT8_MMA_INDEX == mlp_fused.INT8_WQ_SIZE)
    assert (buf[:mlp_fused.INT8_MMA_INDEX.size // 4].view(torch.int8)
            [torch.from_numpy(pads)] == 0).all()


def _fragment_product_s8(buf, slab0, k_padded, nt_n, x):
    """x (16, k_padded) int times the rows of a run of k steps, read from the
    buffer with the index arithmetic of mma_run / PipeT
    (csrc/mlp_int8_from_points.cu): lane 4 g + t of warp w finds word r of
    n-tile nt at k step ks at slab * 8192 + w * 1024 + (ks % per_slab) *
    64 NT + (nt // 2) * 128 + lane * 4 + 2 (nt % 2) + r, and its byte j
    multiplies channel 32 ks + 4 t + 16 r + j (the m16n8k32 B fragment)."""
    words = buf.numpy()
    per_slab = 16 // nt_n
    out = np.zeros((x.shape[0], 64 * nt_n), dtype=np.int64)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for ks in range(k_padded // 32):
        for warp in range(8):
            base = (slab0 + ks // per_slab) * 8192 + warp * 1024 \
                + (ks % per_slab) * 64 * nt_n + lane * 4
            for nt in range(nt_n):
                cols = warp * 8 * nt_n + nt * 8 + g
                for r in range(2):
                    w = words[base + (nt // 2) * 128 + 2 * (nt % 2) + r]
                    for j in range(4):
                        byte = ((w >> (8 * j)) & 0xFF).astype(np.int64)
                        byte = np.where(byte > 127, byte - 256, byte)
                        ch = 32 * ks + 4 * t + 16 * r + j
                        np.add.at(out, (slice(None), cols), x[:, ch] * byte)
    return out


@pytest.mark.parametrize("key,slab0,k_padded,nt_n", [
    ("w0", 0, 64, 4), ("w1", 1, 256, 4), ("w4", 7, 256, 4),
    ("w5b", 9, 256, 4), ("w5a", 11, 64, 4), ("wf", 16, 256, 4),
    ("wva", 18, 256, 2), ("wvb", 19, 32, 2)])
def test_int8_mma_buffer_feeds_the_fragments(flagship, key, slab0, k_padded,
                                             nt_n):
    """Reading the buffer as the kernel's lanes do gives the exact integer
    product xq @ q for every kind of run of k steps, the zero padding rows
    meeting nonzero channels included."""
    model = flagship[-1]
    buf = mlp_fused.pack_weights_int8_mma(model)
    W, _B = mlp_fused.unpack_weights_int8(*mlp_fused.pack_weights_int8(model))
    q = W[key][0].numpy().astype(np.int64)
    x = np.random.default_rng(3).integers(-127, 128, (16, k_padded))
    got = _fragment_product_s8(buf, slab0, k_padded, nt_n, x)
    np.testing.assert_array_equal(got, x[:, :q.shape[0]] @ q)


@pytest.mark.parametrize("n", [2048, 1500])
def test_int8_plain_matches_pallas_interpret_at_its_block(flagship, n):
    cfg, jparams, jls, model = flagship
    pts, vd = _points(n, seed=4)
    want = np.asarray(mlp_pallas.fused_nerf_mlp_int8_from_points(
        jparams, jls, jnp.asarray(pts), jnp.asarray(vd), cfg))
    # the reference pads N to its 2,048-point tile with zero rows, which
    # enter its half tile's activation scales (mlp_pallas.py:374-376)
    n_pad = -(-n // mlp_pallas.TILE) * mlp_pallas.TILE
    pad = lambda a: torch.from_numpy(np.pad(a, ((0, n_pad - n), (0, 0))))
    got = mlp_fused.fused_nerf_mlp_int8_from_points_plain(
        *mlp_fused.pack_weights_int8(model), pad(pts), pad(vd),
        block=mlp_pallas.TILE // 2)[:n].numpy()
    ref = np.asarray(jnerf.apply_mlp(jparams, jposenc(jnp.asarray(pts), 10),
                                     jposenc(jnp.asarray(vd), 4), cfg,
                                     ls=jls))
    scale = np.abs(ref).max()
    d = np.abs(got - want)
    assert (d > 1e-4 * scale).mean() <= INT8_TIE_SHARE, \
        ((d > 1e-4 * scale).mean(), d.max())
    assert d.max() < _int8_bound(ref), (d.max(), scale)
    assert np.abs(got - ref).max() < _int8_bound(ref)


@pytest.mark.parametrize("n", [mlp_fused.INT8_ACT_BLOCK * 16 + 7, 33])
def test_int8_at_the_ports_block_within_reference_bound(flagship, n):
    cfg, jparams, jls, model = flagship
    pts, vd = _points(n, seed=5)
    ref = np.asarray(jnerf.apply_mlp(jparams, jposenc(jnp.asarray(pts), 10),
                                     jposenc(jnp.asarray(vd), 4), cfg,
                                     ls=jls))
    before = _build.launch_counts()
    got = mlp_fused.fused_nerf_mlp_int8_from_points(
        model, torch.from_numpy(pts), torch.from_numpy(vd)).numpy()
    assert _build.launch_counts() == before
    assert got.shape == (n, 4) and np.isfinite(got).all()
    err = np.abs(got - ref).max()
    assert 0 < err < _int8_bound(ref), (err, np.abs(ref).max())


def test_int8_blocks_are_independent_and_the_tail_stands_alone(flagship):
    """A point's output depends on its own block of INT8_ACT_BLOCK points
    only, and a last, shorter block is quantized over its own points."""
    _cfg, _jparams, _jls, model = flagship
    blk = mlp_fused.INT8_ACT_BLOCK
    packed = mlp_fused.pack_weights_int8(model)
    pts, vd = (torch.from_numpy(a) for a in _points(3 * blk + 10, seed=6))
    whole = mlp_fused.mlp_int8_from_points(*packed, pts, vd)
    for lo, hi in ((0, blk), (blk, 2 * blk), (3 * blk, 3 * blk + 10)):
        alone = mlp_fused.mlp_int8_from_points(
            *packed, pts[lo:hi].contiguous(), vd[lo:hi].contiguous())
        assert torch.equal(alone, whole[lo:hi])
    assert mlp_fused.mlp_int8_from_points(*packed, pts[:0], vd[:0]).shape \
        == (0, 4)


def test_wrappers_check_inputs(flagship):
    _cfg, _jparams, _jls, model = flagship
    wq, scales, biases = mlp_fused.pack_weights_int8(model)
    packed = mlp_fused.pack_weights(model)
    r3, e63, e27 = torch.zeros(4, 3), torch.zeros(4, 63), torch.zeros(4, 27)
    with pytest.raises(ValueError):
        mlp_fused.mlp_int8_from_points(wq.float(), scales, biases, r3, r3)
    with pytest.raises(ValueError):
        mlp_fused.mlp_int8_from_points(wq, scales[:-1], biases, r3, r3)
    with pytest.raises(ValueError):
        mlp_fused.mlp_int8_from_points(wq, scales, biases, r3.double(), r3)
    with pytest.raises(ValueError):
        mlp_fused.mlp_embedded(packed, e63, e27[:3])
    with pytest.raises(ValueError):
        mlp_fused.mlp_embedded(packed, e63.t().contiguous().t(), e27)
    with pytest.raises(ValueError, match="device"):
        mlp_fused.mlp_embedded(packed.to("meta"), e63.to("meta"),
                               e27.to("meta"))
    # K-B5's fragment-ordered buffer: a short one is refused on the CPU too
    packed_mma = mlp_fused.repack_mma(packed)
    with pytest.raises(ValueError, match="packed_mma"):
        mlp_fused.mlp_embedded(packed, e63, e27, packed_mma=packed_mma[:-64])
    with pytest.raises(ValueError, match="packed_mma"):
        mlp_fused.mlp_embedded(packed, e63, e27,
                               packed_mma=packed_mma.double())
    assert torch.equal(
        mlp_fused.mlp_embedded(packed, e63, e27, packed_mma=packed_mma),
        mlp_fused.fused_nerf_mlp_plain(packed, e63, e27))
    with pytest.raises(ValueError, match="device"):
        mlp_fused.mlp_int8_from_points(wq, scales, biases, r3.to("meta"),
                                       r3.to("meta"))


# ------------------------------------------------------- renderer routes


def _rays(R, seed):
    rng = np.random.default_rng(seed)
    ro = (0.1 * rng.standard_normal((R, 3)) + [0, 0, 4.0]).astype(np.float32)
    rd = (0.2 * rng.standard_normal((R, 3)) + [0, 0, -1.0]) \
        .astype(np.float32)
    vd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    return ro, rd, vd


def _render_both(models, common, R=32, seed=7):
    cfg, jparams, jls, model = models
    ro, rd, vd = _rays(R, seed)
    rc_j = jrenderer.RenderConfig(mlp=cfg, **common)
    rc_t = trenderer.RenderConfig(mlp=model.config, **common)
    want = jrenderer.render_rays(
        jparams, None, jls, None, jnp.asarray(ro), jnp.asarray(rd),
        jnp.asarray(vd), 2.0, 6.0, jax.random.PRNGKey(0), rc_j,
        deterministic=True)
    t = torch.from_numpy
    with torch.no_grad():
        got = trenderer.render_rays(model, None, t(ro), t(rd), t(vd), 2.0,
                                    6.0, rc_t, deterministic=True)
    return got, want, rc_t, (model, t(ro), t(rd), t(vd))


def test_renderer_int8_route_matches_reference(flagship, monkeypatch):
    """use_int8_mlp with use_fused_mlp and posenc 10/4 takes
    fused_nerf_mlp_int8_from_points (renderer.py:89-92). The two packages
    quantize over other blocks (64 points against 1,024 with padding), so
    the renders agree within the reference's bound for this route
    (tests/test_mlp_pallas.py:274: max |d rgb_map| < 0.1), each also against
    the float render. raw2outputs gives a ray's last sample (dist 1e10)
    alpha 1 or 0 by the sign of its sigma, a step that an error of any size
    can cross: the bound is held on the rays whose far sample the float
    model puts further from zero than the int8 error of the raw output
    (tests/test_mlp_pallas.py:255), which must be more than half of them."""
    common = dict(n_samples=8, n_importance=8, perturb=False,
                  use_fused_mlp=True, use_int8_mlp=True, raw_noise_std=1.0)
    calls = []
    real = mlp_fused.fused_nerf_mlp_int8_from_points
    monkeypatch.setattr(mlp_fused, "fused_nerf_mlp_int8_from_points",
                        lambda *a: calls.append(1) or real(*a))
    got, want, rc_t, (model, ro, rd, vd) = _render_both(flagship, common)
    assert len(calls) == 2     # coarse and fine pass
    with torch.no_grad():
        exact = trenderer.render_rays(
            model, None, ro, rd, vd, 2.0, 6.0,
            dataclasses.replace(rc_t, use_int8_mlp=False),
            deterministic=True)
        raw_far = mlp_fused.fused_nerf_mlp_from_points(model, ro + rd * 6.0,
                                                       vd)
    steady = (raw_far[:, 3].abs() > _int8_bound(raw_far.numpy())).numpy()
    assert steady.sum() > 0.5 * len(steady)
    for k in ("rgb_map", "rgb0", "acc_map"):
        g = got[k].numpy()[steady]
        assert np.isfinite(got[k].numpy()).all()
        assert np.abs(g - np.asarray(want[k])[steady]).max() < 0.1, k
        assert np.abs(g - exact[k].numpy()[steady]).max() < 0.1, k
    assert float((got["rgb_map"] - exact["rgb_map"]).abs().max()) > 0


def test_renderer_int8_without_fused_mlp_is_the_float_render(flagship):
    """use_int8_mlp alone changes nothing, as in the reference (the flag is
    read only on the fused 10/4 route)."""
    common = dict(n_samples=8, n_importance=0, perturb=False,
                  use_int8_mlp=True)
    got, want, _rc, _ = _render_both(flagship, common, R=16)
    np.testing.assert_allclose(got["rgb_map"].numpy(),
                               np.asarray(want["rgb_map"]), atol=2e-5)


@pytest.mark.parametrize("fused_compositing", [False, True])
def test_renderer_other_posenc_route_matches_reference(flagship, monkeypatch,
                                                       fused_compositing):
    """use_fused_mlp with multires 6/4: the embeddings are made outside and
    go to fused_nerf_mlp (renderer.py:96-106), which for an architecture
    whose input widths then differ from 63/27 is the plain MLP. Full fusion
    stays off (renderer.py:124-126)."""
    jcfg = jnerf.NeRFConfig(input_ch=3 + 6 * 6)
    params = jax.tree.map(np.asarray,
                          jnerf.init_params(jax.random.PRNGKey(2), jcfg))
    tcfg = tnerf.NeRFConfig(input_ch=3 + 6 * 6)
    model = tnerf.from_jax_params(params, tcfg)
    assert not mlp_fused.supports(tcfg)
    common = dict(n_samples=8, n_importance=8, perturb=False, multires=6,
                  use_fused_mlp=True, use_fused_compositing=fused_compositing)
    calls = []
    real = mlp_fused.fused_nerf_mlp
    monkeypatch.setattr(mlp_fused, "fused_nerf_mlp",
                        lambda *a: calls.append(1) or real(*a))
    got, want, _rc, _ = _render_both(
        (jcfg, jax.tree.map(jnp.asarray, params), None, model), common, R=16)
    assert len(calls) == 2
    for k in ("rgb_map", "rgb0", "acc_map", "disp_map"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=2e-5, rtol=1e-4, err_msg=k)


def test_renderer_embedded_route_reaches_the_kernel_wrapper(flagship,
                                                            monkeypatch):
    """With the flagship architecture the embedded route ends in the K-B5
    wrapper (the plain version here, on CPU tensors), given the kernel's
    buffer by keyword (None on the CPU)."""
    _cfg, _jparams, _jls, model = flagship
    calls = []
    real = mlp_fused.mlp_embedded
    monkeypatch.setattr(
        mlp_fused, "mlp_embedded",
        lambda *a, **kw: calls.append((a[1].shape, kw)) or real(*a, **kw))
    g = torch.Generator().manual_seed(0)
    pe, ve = torch.randn(6, 4, 63, generator=g), torch.randn(6, 4, 27,
                                                             generator=g)
    out = mlp_fused.fused_nerf_mlp(model, pe, ve)
    assert calls == [((24, 63), {"packed_mma": None})]
    assert out.shape == (6, 4, 4)
