"""K-B1 on the tensor cores (csrc/mlp_train.cu) as far as the CPU reaches it:
the two weight buffers of wgmma images, their cache, and the plain models
of the kernels' arithmetic.

The images are read back by a model of their own, written from the
hardware's rule and the kernel's code rather than from the packing's index
arithmetic: a wgmma descriptor of a K-major 32-bit operand with the 128-byte
swizzle reads value (k step ks, slot s) of row n at the unswizzled byte
a = 128 n + 32 ks + 4 s of the image and finds it at a ^ (((a >> 7) & 7) <<
4); lane 4 g + t of the kernel loads channels 16 h + 4 t .. + 3 of a group's
half h and gives channels 16 h + 4 t + 2 e and + 1 to slots t and t + 4 of
k step 2 h + e.

Tolerances.
  * The buffers are a split and gathers: exact (hi + lo == w).
  * The modelled 3xTF32 chains against float64. Each product is off by at
    most 2^-21 |x||w| per operand (the split) plus float32 sums, so a layer's
    u carries ~1e-6 of sum |x||w|; twelve layers deep the raw logits are held
    to 2e-5 of their largest value (measured 2.4e-7; the exact float32 plain
    version 2.2e-7) and every gradient to 2e-4 of its largest element
    (measured 3.2e-6 at worst, median 4.5e-7; a gradient is a sum over all
    points through relu masks, and where a last-bit change of u flips one at
    a tie it moves further: the float32 plain version reads 1.3e-2 on one of
    the 24 vectors of these inputs). Both must be at least 20x closer than
    the same chains with one TF32 product in place of three (2.7e-4 and
    8e-2).
  * Modelled against the exact float32 plain versions: raw 1e-5 absolute at
    values up to 0.23 (measured 7.5e-8; two float32 chains, sums in another
    order), gradients by the criterion of tests/test_mlp_train_pallas.py:41-50
    (99.9% of the elements within rtol 5e-2 / atol 5e-3 of the gradient's
    max, none off by 5% of it), as tests/test_torch_port_train.py holds the
    plain versions.
  * Modelled at flagship width against the Pallas pair in interpret mode:
    the loss to rtol 1e-5, the gradients by the same criterion
    (tests/test_torch_port_train.py (a), (b)).
"""
import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nnc_tpu.models import nerf as jnerf
from nnc_tpu.ops import mlp_train_pallas
from nnc_tpu_torch.models import nerf as tnerf
from nnc_tpu_torch.ops import mlp_fused, mlp_train_fused
from nnc_tpu_torch.ops.posenc import positional_encoding as tposenc
from nnc_tpu_torch.train import lsa as tlsa

@pytest.fixture(scope="module")
def flagship():
    """Full-width weights and LSA scales (std 0.05) made with numpy, as JAX
    pytrees and as the port's model."""
    cfg = jnerf.NeRFConfig()
    params = jax.tree.map(np.asarray,
                          jnerf.init_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(5)
    ls = {name: (1.0 + 0.05 * rng.standard_normal(p["b"].shape[0]))
          .astype(np.float32) for name, p in params.items()}
    model = tnerf.from_jax_params(params, tnerf.NeRFConfig(), ls=ls)
    return (cfg, jax.tree.map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in ls.items()}, model)


def _weights(model):
    return mlp_train_fused._layer_tensors(model)[0::3]


def _packed(model):
    t = mlp_train_fused._layer_tensors(model)
    return mlp_train_fused.pack_train(t[0::3], t[1::3], t[2::3])


def _points(n, seed=1):
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((n, 3)).astype(np.float32)
    vd = rng.standard_normal((n, 3)).astype(np.float32)
    tgt = rng.standard_normal((n, 4)).astype(np.float32)
    return pts, vd, tgt


# ------------------------------------------------------------- the buffers
def test_train_buffers_round_trip(flagship):
    """Every weight once in the forward buffer as its hi and lo halves
    (zeros elsewhere: the padding rows); every weight the reverse chain
    multiplies by once in the backward buffer, which has no padding rows;
    both read back to the weights exactly."""
    model = flagship[3]
    weights = _weights(model)
    fwd, bwd = mlp_train_fused.pack_train_wgmma(weights)
    W = mlp_train_fused.WG_SLAB
    assert fwd.shape == (mlp_train_fused.FWD_WG_SIZE,) == (145 * W + 640,)
    assert bwd.shape == (mlp_train_fused.BWD_WG_SIZE,) == (136 * W + 640,)
    params, params_t, _ls = _packed(model)
    assert torch.equal(fwd, mlp_train_fused.repack_wgmma(params))
    assert torch.equal(bwd, mlp_train_fused.repack_wgmma_t(params_t))
    P, T = mlp_fused.PARAMS_SIZE, mlp_train_fused.WT_SIZE
    for index, size in ((mlp_train_fused.FWD_WG_INDEX, P),
                        (mlp_train_fused.BWD_WG_INDEX, T)):
        real = index[index < 3 * size]
        assert np.unique(real).size == real.size and real.max() < 3 * size
    # the backward's slabs hold no zero padding: 2 x 136 half-images of
    # every weight it reads
    assert (mlp_train_fused.BWD_WG_INDEX[:136 * W] < 3 * T).all()
    got_f, got_b = mlp_train_fused.unpack_train_wgmma(fwd, bwd)
    assert list(got_f) == list(got_b) == mlp_train_fused.NAMES
    used = {"pts_linears.0": (0, 0), "pts_linears.5": (63, 319),
            "views_linears.0": (0, 256)}
    for name, w in zip(mlp_train_fused.NAMES, weights):
        assert torch.equal(got_f[name], w.detach().t()), name
        lo, hi = used.get(name, (0, w.shape[1]))
        assert torch.equal(got_b[name][:, lo:hi], w.detach()[:, lo:hi]), name
        rest = torch.cat([got_b[name][:, :lo], got_b[name][:, hi:]], dim=1)
        assert rest.numel() == 0 or float(rest.abs().max()) == 0.0, name
    o = 145 * W
    assert torch.equal(fwd[o:o + 256], weights[9].detach().reshape(-1))
    assert torch.equal(fwd[o + 256:o + 640].view(128, 3),
                       weights[11].detach().t())              # rgb (in, out)
    with pytest.raises(ValueError):
        mlp_train_fused.repack_wgmma_t(params_t[:-1])
    with pytest.raises(ValueError):
        mlp_train_fused.repack_wgmma(params[:-1])
    with pytest.raises(ValueError):
        mlp_train_fused.unpack_train_wgmma(fwd, bwd[:-1])


def test_bias_gather_and_small_vectors(flagship):
    model = flagship[3]
    t = mlp_train_fused._layer_tensors(model)
    params, _pt, ls = _packed(model)
    b = mlp_train_fused.gather_biases(params)
    assert b.shape == ls.shape == (mlp_train_fused.U_SIZE,) == (2436,)
    assert torch.equal(b, torch.cat([x.detach() for x in t[1::3]]))
    assert torch.equal(ls, torch.cat([x.detach().reshape(-1)
                                      for x in t[2::3]]))
    # the view layer's columns start at an odd offset: the kernels use
    # 4-byte accesses there and 8-byte ones everywhere else
    offs = dict(zip(mlp_train_fused.NAMES, mlp_train_fused.U_OFFSETS))
    assert offs["views_linears.0"] == 2305 and offs["alpha_linear"] == 2304
    assert all(offs[f"pts_linears.{i}"] == 256 * i for i in range(8))
    assert offs["feature_linear"] == 2048 and offs["rgb_linear"] == 2433


def test_split_halves(flagship):
    """hi is each weight rounded to TF32 (to nearest, ties away from zero:
    mlp_fused.tf32_round, as the kernels split A), lo = w - hi exactly, so
    hi + lo gives back each float32 weight, and lo as the tensor core reads
    it (cut to TF32) leaves at most 2^-21 |w|."""
    model = flagship[3]
    params, _pt, _ls = _packed(model)
    fwd = mlp_train_fused.repack_wgmma(params)
    index = torch.from_numpy(mlp_train_fused.FWD_WG_INDEX)
    P = mlp_fused.PARAMS_SIZE
    his = index[(index >= P) & (index < 2 * P)]
    los = index[(index >= 2 * P) & (index < 3 * P)]
    hi = torch.zeros(P)
    lo = torch.zeros(P)
    hi[his - P] = fwd[(index >= P) & (index < 2 * P)]
    lo[los - 2 * P] = fwd[(index >= 2 * P) & (index < 3 * P)]
    w = params[his - P]
    assert torch.equal(hi[his - P], mlp_fused.tf32_round(w))
    assert not (hi[his - P].view(torch.int32) & 0x1FFF).any()
    assert torch.equal(hi[his - P] + lo[his - P], w)
    assert torch.equal(lo[his - P], w - mlp_fused.tf32_round(w))
    cut = mlp_fused.tf32_truncate(lo[his - P])
    assert bool(((w - hi[his - P] - cut).abs()
                 <= 2.0 ** -21 * w.abs()).all())


def _image_values(buf, base, rows):
    """The (32, rows) values (k step ks, slot s) -> row 8 ks + s of an image
    of ``rows`` rows at float offset ``base``, by the descriptor's rule."""
    ks = np.arange(4)[:, None, None]
    s = np.arange(8)[None, :, None]
    n = np.arange(rows)[None, None, :]
    a = 128 * n + 32 * ks + 4 * s
    phys = a ^ (((a >> 7) & 7) << 4)
    return buf[base + phys.reshape(32, rows) // 4]


def _group_channels():
    """The group channel in each (k step, slot) of the kernel's A registers,
    from its loads: lane (g, t) holds channels 16 h + 4 t + 0..3 of half h,
    and gives 16 h + 4 t + 2 e to slot t of k step 2 h + e, the next channel
    to slot t + 4."""
    ch = np.empty((4, 8), dtype=np.int64)
    for h in range(2):
        for e in range(2):
            for t in range(4):
                ch[2 * h + e, t] = 16 * h + 4 * t + 2 * e
                ch[2 * h + e, t + 4] = 16 * h + 4 * t + 2 * e + 1
    return ch.reshape(32)


def _wg_product(buf, slab0, k_padded, n_out, x):
    """x (64, k_padded) times B as the kernel's products read it from the
    buffer: group q's hi and lo images in slabs slab0 + 2 q and + 1 (n_out
    256), or in slab slab0 + q, lo 16 KB after hi (n_out 128); hi + lo."""
    b = buf.numpy().astype(np.float64)
    ch = _group_channels()
    out = np.zeros((64, n_out))
    W = mlp_train_fused.WG_SLAB
    for q in range(k_padded // 32):
        if n_out == 256:
            hi, lo = (slab0 + 2 * q) * W, (slab0 + 2 * q + 1) * W
        else:
            hi = (slab0 + q) * W
            lo = hi + 4096
        B = _image_values(b, hi, n_out) + _image_values(b, lo, n_out)
        out += x[:, 32 * q + ch] @ B
    return out


# (layer, first row, rows, first slab, rows padded, outputs): the schedule
# train_layer walks (kFwdSlabs = 145): two slabs a group of a 256-wide
# layer, one a group of the view layer
FWD_RUNS = [("pts_linears.0", 0, 63, 0, 64, 256)] + [
    (f"pts_linears.{i}", 0, 256, 4 + 16 * (i - 1), 256, 256)
    for i in (1, 2, 3, 4)
] + [("pts_linears.5", 0, 63, 68, 64, 256),
     ("pts_linears.5", 63, 256, 72, 256, 256),
     ("pts_linears.6", 0, 256, 88, 256, 256),
     ("pts_linears.7", 0, 256, 104, 256, 256),
     ("feature_linear", 0, 256, 120, 256, 256),
     ("views_linears.0", 0, 256, 136, 256, 128),
     ("views_linears.0", 256, 27, 144, 32, 128)]


@pytest.mark.parametrize("name,row0,rows,slab0,k_padded,n_out", FWD_RUNS)
def test_forward_images_feed_the_products(flagship, name, row0, rows, slab0,
                                          k_padded, n_out):
    """Reading the forward buffer as train_layer's products do gives x @ W
    of the unscaled weights for every run of groups."""
    model = flagship[3]
    fwd, _ = mlp_train_fused.pack_train_wgmma(_weights(model))
    w = dict(zip(mlp_train_fused.NAMES, _weights(model)))[name] \
        .detach().t().numpy().astype(np.float64)
    x = np.random.default_rng(3).standard_normal((64, k_padded))
    got = _wg_product(fwd, slab0, k_padded, n_out, x)
    np.testing.assert_allclose(got, x[:, :rows] @ w[row0:row0 + rows],
                               rtol=0, atol=1e-12)


# (layer, first input column, du's width K, first slab): the schedule
# bwd_layer walks (kBwdSlabs = 136), 8 slabs for K = 128 and 16 for K = 256
BWD_RUNS = [("views_linears.0", 0, 128, 0), ("feature_linear", 0, 256, 8)] + [
    (f"pts_linears.{i}", 63 if i == 5 else 0, 256, 24 + 16 * (7 - i))
    for i in range(7, 0, -1)]


@pytest.mark.parametrize("name,col0,k,slab0", BWD_RUNS)
def test_backward_images_feed_the_products(flagship, name, col0, k, slab0):
    """Reading the backward buffer as bwd_layer's products do gives
    du @ W[:, col0:col0 + 256] of torch's (out, in) weight: dx."""
    model = flagship[3]
    assert [r[0] for r in BWD_RUNS] == \
        [r[0] for r in mlp_train_fused.BWD_RUNS]
    _, bwd = mlp_train_fused.pack_train_wgmma(_weights(model))
    w = dict(zip(mlp_train_fused.NAMES, _weights(model)))[name] \
        .detach().numpy().astype(np.float64)
    assert w.shape[0] == k
    du = np.random.default_rng(4).standard_normal((64, k))
    got = _wg_product(bwd, slab0, k, 256, du)
    np.testing.assert_allclose(got, du @ w[:, col0:col0 + 256], rtol=0,
                               atol=1e-12)


def test_backward_buffer_heads(flagship):
    model = flagship[3]
    weights = _weights(model)
    _, bwd = mlp_train_fused.pack_train_wgmma(weights)
    o = mlp_train_fused.BWD_WG_SLABS * mlp_train_fused.WG_SLAB
    assert BWD_RUNS[-1][3] + 16 == mlp_train_fused.BWD_WG_SLABS
    assert FWD_RUNS[-1][3] + 1 == mlp_train_fused.FWD_WG_SLABS
    assert torch.equal(bwd[o:o + 256], weights[9].detach().reshape(-1))
    assert torch.equal(bwd[o + 256:o + 640].view(3, 128),
                       weights[11].detach())
    assert bwd.numel() == o + 640


def test_kernel_buffer_checks():
    made = []
    make = lambda src: made.append(src) or torch.zeros(8)
    kb = mlp_train_fused._kernel_buffer
    assert kb("x", None, 8, "src", make).shape == (8,) and made == ["src"]
    given = torch.ones(8)
    assert kb("x", given, 8, None, make) is given and made == ["src"]
    with pytest.raises(ValueError, match="neither"):
        kb("x", None, 8, None, make)
    with pytest.raises(ValueError):
        kb("x", torch.ones(7), 8, None, make)
    with pytest.raises(ValueError, match="aligned"):
        kb("x", torch.ones(9)[1:], 8, None, make)


# ---------------------------------------------------------------- the cache
def _small_model(seed):
    return tnerf.init_lsa_scales(
        tnerf.init_params(tnerf.NeRFConfig(), torch.Generator()
                          .manual_seed(seed)), std=0.05,
        generator=torch.Generator().manual_seed(seed + 1))


def test_pack_cache_hits_and_misses():
    cache = mlp_train_fused.TrainPackCache()
    model = _small_model(0)
    w = _weights(model)
    first = cache.get(w)
    assert (cache.hits, cache.misses) == (0, 1)
    assert cache.get(_weights(model)) is first
    assert (cache.hits, cache.misses) == (1, 1)
    want = mlp_train_fused.pack_train_wgmma(w)
    assert all(torch.equal(a, b) for a, b in zip(first, want))
    # scales and biases are no part of the key
    with torch.no_grad():
        for layer in model.layers().values():
            layer.bias.add_(1.0)
            layer.weight_scaling.mul_(1.5)
    assert cache.get(_weights(model)) is first
    assert (cache.hits, cache.misses) == (2, 1)
    # an in-place change of one weight misses, and packs the new value
    with torch.no_grad():
        model.layers()["pts_linears.3"].weight.mul_(2.0)
    second = cache.get(_weights(model))
    assert (cache.hits, cache.misses) == (2, 2) and second is not first
    assert all(torch.equal(a, b) for a, b in zip(
        second, mlp_train_fused.pack_train_wgmma(_weights(model))))
    assert not torch.equal(second[0], first[0])
    assert cache.get(_weights(model)) is second
    # a swap of .data (what module.to does) keeps object and version
    layer = model.layers()["pts_linears.0"]
    layer.weight.data = layer.weight.data.clone()
    assert cache.get(_weights(model)) is not second
    assert (cache.hits, cache.misses) == (3, 3)
    # another model, equal in value: its own entry
    twin = _small_model(0)
    cache.get(_weights(twin))
    assert (cache.hits, cache.misses) == (3, 4)
    # a copy of the model, as a replica on another device is: new tensors
    cache.get(_weights(copy.deepcopy(twin)))
    assert (cache.hits, cache.misses) == (3, 5)
    cache.get(_weights(twin))
    assert (cache.hits, cache.misses) == (4, 5)


def test_pack_cache_keeps_the_most_recent():
    cache = mlp_train_fused.TrainPackCache(size=2)
    models = [_small_model(s) for s in range(3)]
    for m in models:
        cache.get(_weights(m))
    assert cache.misses == 3 and len(cache._entries) == 2
    cache.get(_weights(models[2]))
    cache.get(_weights(models[1]))
    assert cache.hits == 2
    cache.get(_weights(models[0]))       # dropped as the oldest
    assert cache.misses == 4


@pytest.mark.parametrize("with_dw,misses", [(False, 1), (True, 4)])
def test_lsa_steps_pack_once(with_dw, misses):
    """k optimizer steps on the tensors LSA trains (scales, and biases when
    fine-tuning) look the weights' buffers up as fused_nerf_mlp_train does
    for CUDA tensors: one miss, k - 1 hits. Training the weights too
    (with_dw) changes them in place every step: every lookup misses."""
    k = 4
    cache = mlp_train_fused.TrainPackCache()
    model = _small_model(3)
    trained = tlsa.trained_tensors(model, None, tune_scales=True,
                                   tune_biases=True)
    if with_dw:
        for layer in model.layers().values():
            layer.weight.requires_grad_(True)
            trained.append(layer.weight)
    opt = torch.optim.Adam(trained, lr=1e-3)
    pts, vd, tgt = (torch.from_numpy(a) for a in _points(16, seed=8))
    for _ in range(k):
        cache.get(_weights(model))
        opt.zero_grad(set_to_none=True)
        raw = mlp_train_fused.fused_nerf_mlp_train(model, pts, vd,
                                                   with_dw=with_dw)
        torch.mean((raw - tgt) ** 2).backward()
        opt.step()
    assert (cache.misses, cache.hits) == (misses, k - misses)


# ------------------------------------------------ the modelled arithmetic
def _one_tf32(x, w):
    return mlp_fused.tf32_round(x) @ mlp_fused.tf32_round(w)


def _float64(fn, *tensors, **kw):
    """fn on the float64 copies of the tensors."""
    default = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        return fn(*(t.double() for t in tensors), **kw)
    finally:
        torch.set_default_dtype(default)


def _parts(flat):
    _dw, dls, db = mlp_train_fused.split_grads(flat, False)
    return [(f"dls {n}", dls[n]) for n in dls] + \
        [(f"db {n}", db[n]) for n in db]


@pytest.fixture(scope="module")
def chains(flagship):
    """The forward and the backward without dW of 700 points: float64,
    exact float32 plain, modelled 3xTF32, and one TF32 product."""
    model = flagship[3]
    params, params_t, ls = _packed(model)
    pts, vd, cot = (torch.from_numpy(a) for a in _points(700, seed=3))
    args = (params, params_t, ls, pts, vd, cot)
    fwd = lambda mm: mlp_train_fused.mlp_train_fwd_plain(
        params, ls, pts, vd, mm=mm)
    bwd = lambda mm: mlp_train_fused.mlp_train_bwd_plain(*args, False, mm=mm)
    return {
        "exact": (_float64(mlp_train_fused.mlp_train_fwd_plain, params, ls,
                           pts, vd),
                  _float64(mlp_train_fused.mlp_train_bwd_plain, *args,
                           with_dw=False)),
        "plain": (mlp_train_fused.mlp_train_fwd_plain(params, ls, pts, vd),
                  mlp_train_fused.mlp_train_bwd_plain(*args, False)),
        "model": (mlp_train_fused.mlp_train_fwd_3xtf32_plain(params, ls, pts,
                                                             vd),
                  mlp_train_fused.mlp_train_bwd_3xtf32_plain(*args)),
        "one": (fwd(_one_tf32), bwd(_one_tf32)),
    }


def test_modelled_forward_against_float64(chains):
    exact = chains["exact"][0]
    scale = float(exact.abs().max())
    err = float((chains["model"][0].double() - exact).abs().max())
    err_plain = float((chains["plain"][0].double() - exact).abs().max())
    err_one = float((chains["one"][0].double() - exact).abs().max())
    assert err <= 2e-5 * scale, (err, scale)
    assert err <= 4 * err_plain + 1e-7 * scale, (err, err_plain)
    assert err * 20 <= err_one, (err, err_one)


def test_modelled_backward_against_float64(chains):
    worst, worst_one = 0.0, 0.0
    for (what, got), (_w, want), (_o, one) in zip(
            _parts(chains["model"][1]), _parts(chains["exact"][1]),
            _parts(chains["one"][1])):
        scale = max(float(want.abs().max()), 1e-30)
        err = float((got.double() - want).abs().max()) / scale
        assert err <= 2e-4, (what, err)
        worst = max(worst, err)
        worst_one = max(worst_one,
                        float((one.double() - want).abs().max()) / scale)
    assert worst * 20 <= worst_one, (worst, worst_one)


def _grads_close(got, want, msg):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(np.abs(want).max(), 1e-12)
    close = np.isclose(got, want, rtol=5e-2, atol=5e-3 * scale)
    assert close.mean() > 0.999, (msg, 1 - close.mean())
    assert np.abs(got - want).max() < 0.05 * scale, (msg, scale)


def test_modelled_against_plain(chains):
    raw_m, flat_m = chains["model"]
    raw_p, flat_p = chains["plain"]
    np.testing.assert_allclose(raw_m.numpy(), raw_p.numpy(), rtol=0,
                               atol=1e-5)
    assert flat_m.shape == flat_p.shape == (mlp_train_fused.grad_size(False),)
    for (what, got), (_w, want) in zip(_parts(flat_m), _parts(flat_p)):
        _grads_close(got.numpy(), want.numpy(), what)


def test_modelled_backward_reads_the_unpacked_buffers(flagship, chains):
    """The reverse chain needs no weight the backward buffer leaves out: on
    the (out, in) weights read back from it (zeros elsewhere) the modelled
    backward gives the same bits."""
    model = flagship[3]
    params, _pt, ls = _packed(model)
    _, got_b = mlp_train_fused.unpack_train_wgmma(
        *mlp_train_fused.pack_train_wgmma(_weights(model)))
    params_t = torch.cat([got_b[n].reshape(-1)
                          for n in mlp_train_fused.NAMES])
    pts, vd, cot = (torch.from_numpy(a) for a in _points(700, seed=3))
    flat = mlp_train_fused.mlp_train_bwd_3xtf32_plain(params, params_t, ls,
                                                      pts, vd, cot)
    assert torch.equal(flat, chains["model"][1])


@pytest.mark.parametrize("n", [mlp_train_pallas.TILE,
                               mlp_train_pallas.TILE + 17])
def test_modelled_forward_matches_pallas(flagship, n):
    cfg, jparams, jls, model = flagship
    pts, vd, tgt = _points(n)
    raw = mlp_train_pallas.fused_nerf_mlp_train(
        jparams, jls, jnp.asarray(pts), jnp.asarray(vd), cfg)
    want = float(jnp.mean((raw - jnp.asarray(tgt)) ** 2))
    params, _pt, ls = _packed(model)
    got_raw = mlp_train_fused.mlp_train_fwd_3xtf32_plain(
        params, ls, torch.from_numpy(pts), torch.from_numpy(vd))
    got = float(torch.mean((got_raw - torch.from_numpy(tgt)) ** 2))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got_raw.numpy(), np.asarray(raw), rtol=0,
                               atol=2e-5)


def test_modelled_backward_matches_pallas(flagship):
    cfg, jparams, jls, model = flagship
    n = mlp_train_pallas.TILE
    pts, vd, tgt = _points(n, seed=2)

    def loss(ls, params):
        raw = mlp_train_pallas.fused_nerf_mlp_train(
            params, ls, jnp.asarray(pts), jnp.asarray(vd), cfg)
        return jnp.mean((raw - jnp.asarray(tgt)) ** 2)

    g_ls, g_p = jax.grad(loss, argnums=(0, 1))(jls, jparams)
    params, params_t, ls = _packed(model)
    tpts, tvd, ttgt = (torch.from_numpy(a) for a in (pts, vd, tgt))
    raw = mlp_train_fused.mlp_train_fwd_3xtf32_plain(params, ls, tpts, tvd)
    cot = 2.0 * (raw - ttgt) / raw.numel()
    flat = mlp_train_fused.mlp_train_bwd_3xtf32_plain(params, params_t, ls,
                                                      tpts, tvd, cot)
    _dw, dls, db = mlp_train_fused.split_grads(flat, False)
    for name in g_ls:
        _grads_close(dls[name].numpy(), g_ls[name], f"{name} ls")
        _grads_close(db[name].numpy(), g_p[name]["b"], f"{name} b")


def _dw_views(flat):
    return mlp_train_fused.split_grads(
        torch.cat([flat, flat.new_zeros(2 * mlp_train_fused.U_SIZE)]),
        True)[0]


def test_two_pass_dw_plain_matches_pallas(flagship):
    """The backward with dW in the kernels' two passes, plain: the first
    pass's du workspace, then X^T dU over blocks of DW_BLOCK points in
    DW_CHUNK chunks (chunks of 256 here, so that 1,000 points make four,
    the last ragged), against jax.vjp of fused_nerf_mlp_train with_dw (the
    Pallas _bwd_call in interpret mode), by the gradients' criterion, and
    against the one-pass plain version to float32 reassociation. Rows past
    the points (1,000 to 1,024) hold du = 0."""
    cfg, jparams, jls, model = flagship
    n = 1000
    pts, vd, _tgt = _points(n, seed=9)
    g = (1e-2 * np.random.default_rng(10).standard_normal((n, 4))) \
        .astype(np.float32)
    _raw, vjp = jax.vjp(lambda p: mlp_train_pallas.fused_nerf_mlp_train(
        p, jls, jnp.asarray(pts), jnp.asarray(vd), cfg, with_dw=True),
        jparams)
    (want,) = vjp(jnp.asarray(g))
    params, params_t, ls = _packed(model)
    tpts, tvd, tg = (torch.from_numpy(a) for a in (pts, vd, g))
    ws, du = mlp_train_fused.train_workspaces_plain(params, params_t, ls,
                                                    tpts, tvd, tg)
    assert ws.shape == du.shape == (1024, mlp_train_fused.U_SIZE)
    assert float(du[n:].abs().max()) == 0.0 and du[:n].abs().max() > 0
    biases = mlp_train_fused.gather_biases(params)
    flat = mlp_train_fused.mlp_train_dw_plain(ws, du, ls, biases, tpts, tvd,
                                              chunk=256)
    assert flat.shape == (mlp_train_fused.WT_SIZE,)
    one_pass = mlp_train_fused.split_grads(mlp_train_fused.mlp_train_bwd_plain(
        params, params_t, ls, tpts, tvd, tg, True), True)[0]
    for name, dw in _dw_views(flat).items():
        _grads_close(dw.numpy().T, want[name]["w"], f"dW {name}")
        scale = float(one_pass[name].abs().max())
        assert float((dw - one_pass[name]).abs().max()) <= 1e-5 * scale, name
    # the chunks are summed in a fixed order: the chunk size is part of the
    # function only through float32 reassociation
    whole = mlp_train_fused.mlp_train_dw_plain(ws, du, ls, biases, tpts, tvd)
    assert float((whole - flat).abs().max()) <= \
        1e-5 * float(flat.abs().max())


# ------------------------------------------------------- CPU tensors: plain
def test_cpu_tensors_take_the_plain_versions(flagship):
    """On CPU tensors the wrappers run the exact float32 plain versions
    whatever buffers they are handed, the cache is not consulted, and the
    gradients through _TrainMLP equal torch autograd's through
    nerf.apply_mlp(output_scaling=True)."""
    model = flagship[3]
    params, params_t, ls = _packed(model)
    fwd, bwd = mlp_train_fused.pack_train_wgmma(_weights(model))
    b = mlp_train_fused.gather_biases(params)
    pts, vd, tgt = (torch.from_numpy(a) for a in _points(70, seed=6))
    want = mlp_train_fused.mlp_train_fwd_plain(params, ls, pts, vd)
    raw, ws = mlp_train_fused.mlp_train_fwd(params, ls, pts, vd, save_u=True,
                                            packed_wg=fwd, biases=b)
    assert ws is None and torch.equal(raw, want)
    flat = mlp_train_fused.mlp_train_bwd(params, params_t, ls, pts, vd, tgt,
                                         None, False, packed_wg_t=bwd,
                                         biases=b)
    assert torch.equal(flat, mlp_train_fused.mlp_train_bwd_plain(
        params, params_t, ls, pts, vd, tgt, False))
    with pytest.raises(ValueError):
        mlp_train_fused.mlp_train_fwd(params, ls[:-1], pts, vd)
    with pytest.raises(ValueError, match="plain version"):
        mlp_train_fused.mlp_train_fwd(None, ls, pts, vd, packed_wg=fwd,
                                      biases=b)
    with pytest.raises(ValueError, match="plain version"):
        mlp_train_fused.mlp_train_bwd(params, None, ls, pts, vd, tgt, None,
                                      False, packed_wg_t=bwd, biases=b)

    before = (mlp_train_fused.TRAIN_PACKS.hits,
              mlp_train_fused.TRAIN_PACKS.misses)
    layers = model.layers().values()
    for layer in layers:
        layer.bias.requires_grad_(True)
        layer.weight_scaling.requires_grad_(True)
        layer.bias.grad = layer.weight_scaling.grad = None
    got_raw = mlp_train_fused.fused_nerf_mlp_train(model, pts, vd)
    assert torch.equal(got_raw.detach(), want)
    torch.mean((got_raw - tgt) ** 2).backward()
    got = [(l.bias.grad.clone(), l.weight_scaling.grad.clone())
           for l in layers]
    for layer in layers:
        layer.bias.grad = layer.weight_scaling.grad = None
    ref = tnerf.apply_mlp(model, tposenc(pts, 10), tposenc(vd, 4),
                          output_scaling=True)
    torch.mean((ref - tgt) ** 2).backward()
    for (name, layer), (gb, gl) in zip(model.layers().items(), got):
        _grads_close(gb.numpy(), layer.bias.grad.numpy(), f"{name} b")
        _grads_close(gl.numpy(), layer.weight_scaling.grad.numpy(),
                     f"{name} ls")
        layer.bias.requires_grad_(False)
        layer.weight_scaling.requires_grad_(False)
        layer.bias.grad = layer.weight_scaling.grad = None
    assert (mlp_train_fused.TRAIN_PACKS.hits,
            mlp_train_fused.TRAIN_PACKS.misses) == before
