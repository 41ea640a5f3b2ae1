"""The tensor-core chain of K-B3 / K-B5 / K-B2 (csrc/nerf_mlp_mma.cuh) as far
as the CPU reaches it: the TF32 split, the fragment-ordered weight buffer and
the plain model of the compensated product.

Tolerances: a TF32 value keeps 10 explicit mantissa bits, so rounding to
nearest is off by at most 2^-11 |x| and hi + lo (lo cut to TF32, as the
tensor core reads it) by at most 2^-21 |x|. The compensated product drops
lo * lo (<= 2^-20 of a product) and sums in float32: against float64 it is
held to 4e-6 x sum |x||w| (two float32 ulps of the worst case), and must be
at least 100x closer than the single TF32 product. The modelled chain at
width 32 against the JAX MLP in float32: rtol 1e-4, atol 1e-5 (ten layers of
sums in another order), the tolerance of tests/test_torch_port_fused.py.
K-B6's model (``fused_pair_3xtf32_plain``: 3xTF32 products, sums in two
levels of 32 channels) against the reference's Pallas pair in interpret mode:
rtol 1e-5, atol 1e-5, the bar of the exact plain version against it
(tests/test_torch_port_parallel.py (b)); the modelled error is ~1.5e-6 at
outputs up to ~6, and a single TF32 product lies far outside the bar.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nnc_tpu.models import nerf as jnerf
from nnc_tpu.ops import mlp_pallas, mlp_tp_pallas
from nnc_tpu_torch.models import nerf as tnerf
from nnc_tpu_torch.ops import mlp_fused, mlp_tp_fused


def _values(n, seed):
    """float32 values over many binades, both signs, with exact ties."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * np.exp2(rng.integers(-20, 20, n))) \
        .astype(np.float32)
    ties = np.array([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -11,
                     0.0, -0.0, 1.0, 2.0 ** -126, 3.0e38], np.float32)
    return torch.from_numpy(np.concatenate([x, ties]))


def test_tf32_round_properties():
    x = _values(20_000, 0)
    hi = mlp_fused.tf32_round(x)
    bits = hi.view(torch.int32)
    assert int((bits & 0x1FFF).abs().max()) == 0
    assert torch.equal(mlp_fused.tf32_round(hi), hi)
    xd, hd = x.double(), hi.double()
    assert bool(((xd - hd).abs() <= 2.0 ** -11 * xd.abs()).all())
    # ties go away from zero, as cvt.rna rounds
    t = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert mlp_fused.tf32_round(t).tolist() == [1.0 + 2.0 ** -10,
                                                -(1.0 + 2.0 ** -10)]
    # infinities and NaNs pass through
    odd = torch.tensor([float("inf"), float("-inf"), float("nan")])
    got = mlp_fused.tf32_round(odd)
    assert torch.equal(got[:2], odd[:2]) and bool(torch.isnan(got[2]))


def test_split_tf32_within_2_pow_minus_21():
    x = _values(20_000, 1)
    hi, lo = mlp_fused.split_tf32(x)
    assert torch.equal(hi, mlp_fused.tf32_round(x))
    assert int((lo.view(torch.int32) & 0x1FFF).abs().max()) == 0
    xd = x.double()
    assert bool(((xd - (hi.double() + lo.double())).abs()
                 <= 2.0 ** -21 * xd.abs()).all())
    # the rest x - hi is exact in float32, so lo is that rest cut to TF32
    assert torch.equal(lo, mlp_fused.tf32_truncate(x - hi))


@pytest.fixture(scope="module")
def flagship_model():
    g = torch.Generator().manual_seed(0)
    model = tnerf.init_params(tnerf.NeRFConfig(), g)
    return tnerf.init_lsa_scales(model, std=0.05, generator=g)


def test_pack_weights_mma_round_trips(flagship_model):
    """The fragment-ordered buffer holds every weight and bias of
    pack_weights' buffer exactly once, zeros elsewhere, and reads back layer
    by layer."""
    packed = mlp_fused.pack_weights(flagship_model)
    mma = mlp_fused.pack_weights_mma(flagship_model)
    assert mma.shape == (mlp_fused.MMA_PARAMS_SIZE,) == (601152,)
    assert torch.equal(mma, mlp_fused.repack_mma(packed))
    index = mlp_fused.MMA_INDEX
    real = index[index < mlp_fused.PARAMS_SIZE]
    n_values = sum(din * dout + dout for din, dout
                   in tnerf._layer_dims(tnerf.NeRFConfig()).values())
    assert real.size == np.unique(real).size == n_values == 595844
    # the padding: zero rows 63 -> 64 and 27 -> 32, the tail of the last
    # slab, the heads' alignment
    pad = torch.from_numpy(index == mlp_fused.PARAMS_SIZE)
    assert int(pad.sum()) == 601152 - 595844
    assert float(mma[pad].abs().max()) == 0.0 and float(mma[~pad].abs().min()) > 0
    want = mlp_fused.unpack_weights(packed)
    got = mlp_fused.unpack_weights_mma(mma)
    assert list(got) == list(want)
    for name in want:
        assert torch.equal(got[name][0], want[name][0]), name
        assert torch.equal(got[name][1], want[name][1]), name
    with pytest.raises(ValueError):
        mlp_fused.unpack_weights_mma(mma[:-1])
    with pytest.raises(ValueError):
        mlp_fused.repack_mma(packed[:-1])


def _fragment_product(mma, slab0, k_padded, nt_n, x):
    """x (64, k_padded) times the rows of a run of k steps, read from the
    buffer with the index arithmetic of mma_slab / Pipe (nerf_mlp_mma.cuh):
    lane 4 g + t of warp w holds b0, b1 of n-tile nt at k step ks at
    slab * 8192 + w * 1024 + (ks % per_slab) * 64 NT + (nt // 2) * 128 +
    lane * 4 + 2 (nt % 2), and they multiply channels 16 (ks // 2) + 4 t +
    2 (ks % 2) + {0, 1}."""
    w = mma.numpy().astype(np.float64)
    per_slab = 16 // nt_n
    out = np.zeros((64, 64 * nt_n))
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for ks in range(k_padded // 8):
        ch = 16 * (ks // 2) + 4 * t + 2 * (ks % 2)
        for warp in range(8):
            base = (slab0 + ks // per_slab) * 8192 + warp * 1024 \
                + (ks % per_slab) * 64 * nt_n + lane * 4
            for nt in range(nt_n):
                at = base + (nt // 2) * 128 + 2 * (nt % 2)
                cols = warp * 8 * nt_n + nt * 8 + g
                np.add.at(out, (slice(None), cols),
                          x[:, ch] * w[at] + x[:, ch + 1] * w[at + 1])
    return out


@pytest.mark.parametrize("name,row0,rows,slab0,k_padded,nt_n", [
    ("pts_linears.0", 0, 63, 0, 64, 4),
    ("pts_linears.1", 0, 256, 2, 256, 4),
    ("pts_linears.5", 0, 63, 34, 64, 4),
    ("pts_linears.5", 63, 256, 36, 256, 4),
    ("feature_linear", 0, 256, 60, 256, 4),
    ("views_linears.0", 0, 256, 68, 256, 2),
    ("views_linears.0", 256, 27, 72, 32, 2),
])
def test_mma_buffer_feeds_the_fragments(flagship_model, name, row0, rows,
                                        slab0, k_padded, nt_n):
    """Reading the buffer as the kernel's lanes do gives x @ W for every run
    of k steps, the zero padding rows meeting nonzero channels included."""
    mma = mlp_fused.pack_weights_mma(flagship_model)
    w = mlp_fused.unpack_weights(mlp_fused.pack_weights(flagship_model))[name][0]
    x = np.random.default_rng(3).standard_normal((64, k_padded))
    got = _fragment_product(mma, slab0, k_padded, nt_n, x)
    want = x[:, :rows] @ w[row0:row0 + rows].numpy().astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_mma_buffer_biases_and_heads(flagship_model):
    mma = mlp_fused.pack_weights_mma(flagship_model)
    L = mlp_fused.unpack_weights(mlp_fused.pack_weights(flagship_model))
    o = mlp_fused.MMA_SLABS * mlp_fused.MMA_SLAB
    for i in range(8):
        assert torch.equal(mma[o + 256 * i:o + 256 * (i + 1)],
                           L[f"pts_linears.{i}"][1])
    assert torch.equal(mma[o + 2048:o + 2304], L["feature_linear"][1])
    assert torch.equal(mma[o + 2304:o + 2432], L["views_linears.0"][1])
    assert torch.equal(mma[o + 2432:o + 2688], L["alpha_linear"][0][:, 0])
    assert torch.equal(mma[o + 2688:o + 2689], L["alpha_linear"][1])
    assert torch.equal(mma[o + 2692:o + 3076].view(128, 3), L["rgb_linear"][0])
    assert torch.equal(mma[o + 3076:o + 3079], L["rgb_linear"][1])


@pytest.mark.parametrize("k", [63, 256, 319])
def test_matmul_3xtf32_against_float64(k):
    rng = np.random.default_rng(k)
    x = rng.standard_normal((64, k)).astype(np.float32)
    w = (rng.standard_normal((k, 256)) / np.sqrt(k)).astype(np.float32)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    exact = x.astype(np.float64) @ w.astype(np.float64)
    got = mlp_fused.matmul_3xtf32_plain(xt, wt).numpy()
    one = (mlp_fused.tf32_round(xt) @ mlp_fused.tf32_round(wt)).numpy()
    err3 = np.abs(got - exact)
    err1 = np.abs(one - exact)
    scale = np.abs(x).astype(np.float64) @ np.abs(w).astype(np.float64)
    assert (err3 <= 4e-6 * scale).all()
    assert err3.max() * 100 <= err1.max()
    assert np.sqrt((err3 ** 2).mean()) * 100 <= np.sqrt((err1 ** 2).mean())


def test_modelled_chain_matches_jax_mlp_at_small_width():
    """mlp_3xtf32_plain at W = 32 against nnc_tpu's apply_mlp (float32, LSA
    scales folded) on the same numpy-seeded weights and embeddings; the
    single TF32 product on the same inputs is far outside that tolerance."""
    cfg = jnerf.NeRFConfig(W=32)
    params = jax.tree.map(np.asarray,
                          jnerf.init_params(jax.random.PRNGKey(5), cfg))
    rng = np.random.default_rng(6)
    ls = {name: (1.0 + 0.05 * rng.standard_normal(p["b"].shape[0]))
          .astype(np.float32) for name, p in params.items()}
    pe = rng.standard_normal((300, 63)).astype(np.float32)
    ve = rng.standard_normal((300, 27)).astype(np.float32)
    want = np.asarray(jnerf.apply_mlp(
        jax.tree.map(jnp.asarray, params), jnp.asarray(pe), jnp.asarray(ve),
        cfg, ls={k: jnp.asarray(v) for k, v in ls.items()}))
    model = tnerf.from_jax_params(params, tnerf.NeRFConfig(W=32), ls=ls)
    with torch.no_grad():
        L = {name: (layer.effective_weight().t().contiguous(), layer.bias)
             for name, layer in model.layers().items()}
        got = mlp_fused.mlp_3xtf32_plain(L, torch.from_numpy(pe),
                                         torch.from_numpy(ve)).numpy()
        exact = mlp_fused._mlp_packed(L, torch.from_numpy(pe),
                                      torch.from_numpy(ve)).numpy()
        one = mlp_fused._mlp_packed(
            L, torch.from_numpy(pe), torch.from_numpy(ve),
            addmm=lambda b, x, w: b + mlp_fused.tf32_round(x)
            @ mlp_fused.tf32_round(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(exact, want, rtol=1e-4, atol=1e-5)
    assert np.abs(got - want).max() * 20 <= np.abs(one - want).max()


# (wrapper, its plain version, model-level entry, widths of its two inputs):
# K-B3 on points and directions, K-B5 on their embeddings
_MMA_WRAPPERS = {
    "mlp_from_points": (mlp_fused.mlp_from_points,
                        mlp_fused.fused_nerf_mlp_from_points_plain,
                        mlp_fused.fused_nerf_mlp_from_points, (3, 3)),
    "mlp_embedded": (mlp_fused.mlp_embedded, mlp_fused.fused_nerf_mlp_plain,
                     mlp_fused.fused_nerf_mlp, (63, 27)),
}


@pytest.mark.parametrize("wrapper", sorted(_MMA_WRAPPERS))
def test_wrappers_take_the_plain_version_on_the_cpu(flagship_model, wrapper):
    """On CPU tensors the wrappers read no packed_mma (one given is checked
    for its size) and run the exact float32 plain version on pack_weights'
    buffer; packed_mma_for gives nothing to pack there."""
    run, plain, entry, widths = _MMA_WRAPPERS[wrapper]
    packed = mlp_fused.pack_weights(flagship_model)
    g = torch.Generator().manual_seed(1)
    a, b = (torch.randn(70, w, generator=g) for w in widths)
    want = plain(packed, a, b)
    assert torch.equal(run(packed, a, b), want)
    packed_mma = mlp_fused.repack_mma(packed)
    assert torch.equal(run(packed, a, b, packed_mma), want)
    assert torch.equal(run(packed, a, b, packed_mma=packed_mma), want)
    with pytest.raises(ValueError, match="packed_mma"):
        run(packed, a, b, packed_mma[:-64])
    assert mlp_fused.packed_mma_for(flagship_model, a.device) is None
    misses = mlp_fused.PACKS.misses
    entry(flagship_model, a, b)
    entry(flagship_model, a, b)
    assert mlp_fused.PACKS.misses <= misses + 1   # only the float32 buffer


@pytest.mark.parametrize("k", [63, 256])
@pytest.mark.parametrize("s", [32, 64])
@pytest.mark.parametrize("o2,relu_mid", [(256, True), (128, False)])
def test_pair_3xtf32_model_matches_pallas(k, s, o2, relu_mid):
    """K-B6's arithmetic at N = 201 (no multiple of the kernel's 64-point
    tile; the reference's input padded to its 2,048-row tile with zeros)
    against nnc_tpu's fused_pair in interpret mode, and against the exact
    plain version; the same pair with one TF32 product instead of three
    misses the bar."""
    rng = np.random.default_rng(k + s + o2)
    n = 201
    x = rng.standard_normal((n, k)).astype(np.float32)
    wa = (rng.standard_normal((k, s)) / np.sqrt(k)).astype(np.float32)
    ba = rng.standard_normal(s).astype(np.float32)
    wb = (rng.standard_normal((s, o2)) / np.sqrt(s)).astype(np.float32)
    xp = np.zeros((mlp_pallas.TILE, k), np.float32)
    xp[:n] = x
    want = np.asarray(mlp_tp_pallas.fused_pair(
        jnp.asarray(xp), jnp.asarray(wa), jnp.asarray(ba)[None],
        jnp.asarray(wb), relu_mid=relu_mid, interpret=True))[:n]
    t = torch.from_numpy
    got = mlp_tp_fused.fused_pair_3xtf32_plain(t(x), t(wa), t(ba), t(wb),
                                               relu_mid).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    exact = mlp_tp_fused.fused_pair_plain(t(x), t(wa), t(ba), t(wb),
                                          relu_mid).numpy()
    np.testing.assert_allclose(got, exact, rtol=1e-5, atol=1e-5)
    r = mlp_fused.tf32_round
    h = t(ba) + r(t(x)) @ r(t(wa))
    one = (r(torch.relu(h) if relu_mid else h) @ r(t(wb))).numpy()
    assert np.abs(got - want).max() * 20 <= np.abs(one - want).max()
