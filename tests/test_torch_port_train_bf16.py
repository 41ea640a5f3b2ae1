"""LSA training of a bf16 model in nnc_tpu_torch against the JAX package with
``compute_dtype=jnp.bfloat16`` (CPU; the Pallas pair K-B1 runs its bf16
bodies in interpret mode).

The reference has two bf16 training forms and the port keeps both: the plain
(XLA) MLP folds the LSA scale into the weight and then rounds
(nnc_tpu/models/nerf.py:110-116); K-B1 rounds the unscaled weight and scales
u in float32 (mlp_train_pallas.py:77, 108-110). A bf16 value is held in
units of the distance between the reference's bf16 and float32 results ON
THE SAME INPUTS, computed in each test, never with a fixed tolerance:
  * raw logits: rms error <= 1/8 of the distance's rms, max error <= 1/2 of
    the distance's max (tests/test_torch_port_bf16.py's bar);
  * the XLA form's gradients (autograd through the roundings against
    jax.grad through ``astype``): the same bar; they agree to float32
    reassociation (measured ~1e-4 of the distance);
  * K-B1's gradients, each layer's dls, db and dW: rms error <= 1/3 and max
    error <= 3/4 of that layer's distance (measured up to 0.2 and 0.55: a
    gradient sums every point's chain of twelve roundings, and where one
    rounding falls the other way the two chains part, so a gradient gathers
    more of the distance than the logits do); dW, rounded to bf16 at the
    end, may besides be one bf16 step (2^-7 of it) off;
  * a trajectory of Adam steps on the scales: the scales' motion (ls - 1)
    within 1/2 (rms) of the distance between the reference's bf16 and
    float32 trajectories and at least twice as close to the bf16 one as to
    the float32 one (measured 0.21 and 0.33 of the distance: Adam's first
    steps follow the gradients' signs, and a channel whose gradient is near
    zero flips with one rounding; the port in float32 lies 0.006 and 0.016
    of it from the float32 trajectory), the motion itself four times the
    distance;
  * whole renders and decoded bitstreams: PSNR within 0.1 dB
    (BASELINE.json's tolerance).
A value that no rounding reaches (alpha's bias gradient, the sum of the
cotangent) has no distance to be measured in: it is held to float32
reassociation, rtol 1e-5.
The gradient bars hold besides in units of the reference's own spread under
a reordering of the same sums (:func:`_reordered`: the points and every
layer's hidden channels permuted, the same function in exact arithmetic):
the float32 sums that BLAS or XLA take in an order of their own's choosing
(it follows the host's vector width and the operands' shapes and alignment)
decide where a bf16 rounding falls, and one rounding that falls the other
way moves a gradient that sums few values (alpha's scale gradient: one
number; rgb's dW: 384) by a large part of the distance: the reference moves
so far from itself, and the port may too.
The port's training embedding is cos(y); the reference's Pallas kernels
compute sin(y + pi / 2), the sum rounded in float32 (mlp_pallas.py:216-219),
whose bf16 roundings differ in a few high-frequency channels: 0.1-0.15 of
the distance in layers 0-4's gradients of K-B1 (0.003-0.01 with the
reference's form; its XLA form and the port's kernels take cos).
What is exact is held exactly: the packed streams, read back bit for bit and
through the kernels' fragment index arithmetic.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import nnc_tpu
import nnc_tpu_torch
from nnc_tpu import coder
from nnc_tpu.data import synthetic as jsynthetic
from nnc_tpu.framework.executer import NeRFModelExecuter as JExecuter
from nnc_tpu.models import nerf as jnerf
from nnc_tpu.ops import mlp_train_pallas
from nnc_tpu.render import renderer as jrenderer
from nnc_tpu.train import lsa as jlsa
from nnc_tpu.train import presets as jpresets
from nnc_tpu_torch.models import nerf as tnerf
from nnc_tpu_torch.ops import _build, mlp_fused, mlp_train_fused
from nnc_tpu_torch.ops.posenc import positional_encoding as tposenc
from nnc_tpu_torch.render import renderer as trenderer
from nnc_tpu_torch.tools import bench_train_step
from nnc_tpu_torch.train import lsa as tlsa
from nnc_tpu_torch.train import presets as tpresets

BF16_J = jnp.bfloat16
BF16_T = torch.bfloat16
M = mlp_train_fused


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


def _within(got, want16, want32, what, rms_frac, max_frac, rounded=False,
            spread=()):
    """got against the reference's bf16 result, in units of the reference's
    own bf16-to-float32 distance and of its spread under reordered sums.
    ``rounded``: both results are rounded to bf16 at the end (dW), where a
    last-bit difference of the float32 sums moves a value by one bf16 step,
    2^-7 of it at most: each element may be off by that besides.
    ``spread``: the reference's bf16 results on reordered sums
    (:func:`_reordered`); the largest rms and elementwise distance of one of
    them from ``want16`` is allowed besides."""
    got, want16, want32 = (np.asarray(a, np.float64)
                           for a in (got, want16, want32))
    err, dist = got - want16, want16 - want32
    if not dist.any():
        # no rounding reaches it (alpha's bias gradient is the sum of the
        # cotangent): float32 reassociation
        np.testing.assert_allclose(got, want16, rtol=1e-5, err_msg=what)
        return
    moved = [np.asarray(s, np.float64) - want16 for s in spread]
    own_rms = max((_rms(m) for m in moved), default=0.0)
    own_max = max((np.abs(m).max() for m in moved), default=0.0)
    assert _rms(err) <= rms_frac * _rms(dist) + own_rms, \
        (what, _rms(err), _rms(dist), own_rms)
    step = 2.0 ** -7 * np.abs(want16) if rounded else 0.0
    beyond = np.abs(err) - step
    assert beyond.max() <= max_frac * np.abs(dist).max() + own_max, \
        (what, beyond.max(), np.abs(dist).max(), own_max)


REORDERINGS = 8


def _reordered(params, ls, cfg, n, seed):
    """The same network with the order of the n points and of every layer's
    hidden channels permuted: every sum over points and channels taken in
    another order, the same function in exact arithmetic. Returns (params,
    ls, point order, back): ``back(dls, dparams)`` puts the gradients of the
    permuted network into the original one's channel order (numpy;
    ``dparams`` with or without the weights' "w")."""
    rng = np.random.default_rng(1000 + seed)
    out, inp, prev = {}, {}, np.arange(cfg.input_ch)
    for i in range(cfg.D):
        name = f"pts_linears.{i}"
        inp[name], out[name] = prev, rng.permutation(cfg.W)
        prev = out[name] if i not in cfg.skips else np.concatenate(
            [np.arange(cfg.input_ch), cfg.input_ch + out[name]])
    inp["alpha_linear"] = inp["feature_linear"] = prev
    out["alpha_linear"], out["rgb_linear"] = np.arange(1), np.arange(3)
    out["feature_linear"] = rng.permutation(cfg.W)
    out["views_linears.0"] = rng.permutation(cfg.W // 2)
    inp["views_linears.0"] = np.concatenate(
        [out["feature_linear"], cfg.W + np.arange(cfg.input_ch_views)])
    inp["rgb_linear"] = out["views_linears.0"]
    p = {k: {"w": np.asarray(v["w"])[inp[k]][:, out[k]],
             "b": np.asarray(v["b"])[out[k]]} for k, v in params.items()}
    lp = {k: np.asarray(v)[out[k]] for k, v in ls.items()}

    def back(dls, dparams):
        dl, dp = {}, {}
        for k in dls:
            dl[k] = np.empty(np.shape(dls[k]), np.float32)
            dl[k][out[k]] = np.asarray(dls[k])
            dp[k] = {"b": np.empty(np.shape(dparams[k]["b"]), np.float32)}
            dp[k]["b"][out[k]] = np.asarray(dparams[k]["b"])
            if "w" in dparams[k]:
                dp[k]["w"] = np.empty(np.shape(dparams[k]["w"]), np.float32)
                dp[k]["w"][np.ix_(inp[k], out[k])] = \
                    np.asarray(dparams[k]["w"])
        return dl, dp
    return (jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, lp),
            rng.permutation(n), back)


def _net(cfg_kw, seed, activate=True):
    """Weights and LSA scales 1 +- 0.05 made with numpy from a seed: the
    JAX pytrees, and the port's bf16 model of them."""
    params = jnerf.init_params(jax.random.PRNGKey(seed),
                               jnerf.NeRFConfig(**cfg_kw))
    if activate:
        params = jsynthetic._activate(params, seed + 3)
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(seed + 100)
    ls = {name: (1.0 + 0.05 * rng.standard_normal(p["b"].shape[0]))
          .astype(np.float32) for name, p in params.items()}
    model = tnerf.from_jax_params(
        params, tnerf.NeRFConfig(**cfg_kw, compute_dtype=BF16_T), ls=ls)
    return (jax.tree.map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in ls.items()}, model)


def _points(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    vd = rng.standard_normal((n, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    return pts, vd


def _train_all(model, weights=True):
    for layer in model.layers().values():
        for t in (layer.weight, layer.bias, layer.weight_scaling):
            t.requires_grad_(t is not layer.weight or weights)
            t.grad = None


# (a) the XLA form ------------------------------------------------------------
@pytest.mark.parametrize("cfg_kw,n", [(dict(D=3, W=32, skips=(1,)), 300),
                                      (dict(), 64)], ids=["small", "flagship"])
def test_xla_form_values_and_grads_match_jax(cfg_kw, n):
    """apply_mlp(output_scaling=True) of a bf16 model is the reference's
    apply_mlp(ls=ls) in bf16: the same values as the serving form, and
    autograd's scale and bias gradients match jax.grad through the casts."""
    jparams, jls, model = _net(cfg_kw, 1)
    rng = np.random.default_rng(2)
    pe = rng.standard_normal((n, 63)).astype(np.float32)
    ve = rng.standard_normal((n, 27)).astype(np.float32)
    tgt = rng.standard_normal((n, 4)).astype(np.float32)

    def loss(ls, b, cfg, p, x, y):
        p = {k: {"w": v["w"], "b": b[k]} for k, v in p.items()}
        raw = jnerf.apply_mlp(p, x[0], x[1], cfg, ls=ls)
        return jnp.mean((raw - y) ** 2), raw

    grad = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True),
                   static_argnums=2)

    def reference(dt, p, ls, order):
        cfg = jnerf.NeRFConfig(**cfg_kw, compute_dtype=dt)
        return grad(ls, {k: v["b"] for k, v in p.items()}, cfg, p,
                    (jnp.asarray(pe[order]), jnp.asarray(ve[order])),
                    jnp.asarray(tgt[order]))

    want = {dt: reference(dt, jparams, jls, slice(None))
            for dt in (BF16_J, jnp.float32)}
    want_raw = {dt: w[1] for dt, w in want.items()}
    # the reference's own spread: its bf16 gradients on reordered sums
    spread = []
    for seed in range(REORDERINGS):
        p, ls, order, back = _reordered(jparams, jls,
                                        jnerf.NeRFConfig(**cfg_kw), n, seed)
        (gl, gb), _raw = reference(BF16_J, p, ls, order)
        spread.append(back(gl, {k: {"b": v} for k, v in gb.items()}))
    _train_all(model, weights=False)
    t = torch.from_numpy
    raw = tnerf.apply_mlp(model, t(pe), t(ve), output_scaling=True)
    torch.mean((raw - t(tgt)) ** 2).backward()
    with torch.no_grad():
        assert torch.equal(raw, tnerf.apply_mlp(model, t(pe), t(ve)))
    _within(raw.detach().numpy(), want_raw[BF16_J], want_raw[jnp.float32],
            "raw", 1 / 8, 1 / 2)
    (g16_ls, g16_b), (g32_ls, g32_b) = want[BF16_J][0], want[jnp.float32][0]
    for name, layer in model.layers().items():
        _within(layer.weight_scaling.grad.numpy().ravel(), g16_ls[name],
                g32_ls[name], f"{name} ls", 1 / 8, 1 / 2,
                spread=[s[0][name] for s in spread])
        _within(layer.bias.grad.numpy(), g16_b[name], g32_b[name],
                f"{name} b", 1 / 8, 1 / 2,
                spread=[s[1][name]["b"] for s in spread])


def test_the_two_bf16_forms_differ_and_route_by_use_fused_train(monkeypatch):
    """With scales other than one the folded (XLA) form and K-B1's form
    round different numbers; a training render takes K-B1's with
    use_fused_train (its plain bf16 versions on the CPU) and the folded one
    without, and a non-flagship model takes the folded one either way."""
    _jp, _jl, model = _net({}, 3)
    pts, vd = (torch.from_numpy(a) for a in _points(200, 4))
    with torch.no_grad():
        folded = tnerf.apply_mlp(model, tposenc(pts, 10), tposenc(vd, 4),
                                 output_scaling=True)
        kb1 = M.fused_nerf_mlp_train(model, pts, vd)
    assert float((folded - kb1).abs().max()) > 1e-4
    seen = []
    real = M.mlp_train_fwd_bf16_plain
    monkeypatch.setattr(M, "mlp_train_fwd_bf16_plain",
                        lambda *a: seen.append(1) or real(*a))
    monkeypatch.setitem(M._FORMS[True], "fwd_plain",
                        M.mlp_train_fwd_bf16_plain)
    ro = torch.tensor([[0.0, 0.0, 4.0]] * 4)
    rd = torch.tensor([[0.01, 0.02, -1.0]] * 4)
    for fused in (False, True):
        rc = trenderer.RenderConfig(mlp=model.config, n_samples=8,
                                    n_importance=0, use_fused_train=fused)
        out = trenderer.render_rays(model, None, ro, rd, rd, 2.0, 6.0, rc,
                                    deterministic=False)
        assert torch.isfinite(out["rgb_map"]).all()
        assert len(seen) == int(fused)
    small = tnerf.init_params(tnerf.NeRFConfig(W=32, compute_dtype=BF16_T),
                              torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = M.fused_nerf_mlp_train(small, pts, vd)
        want = tnerf.apply_mlp(small, tposenc(pts, 10), tposenc(vd, 4))
    assert torch.equal(got, want)


# (b) K-B1's bf16 forward -----------------------------------------------------
@pytest.fixture(scope="module")
def flagship():
    return _net({}, 0)


def _ptsdir(pts, vd):
    n = pts.shape[0]
    tile = mlp_train_pallas.TILE
    x = np.concatenate([pts, vd, np.zeros((n, 2), np.float32)], -1)
    return jnp.asarray(np.pad(x, ((0, -n % tile), (0, 0))))


@pytest.mark.parametrize("n", [mlp_train_pallas.TILE,
                               mlp_train_pallas.TILE + 17])
def test_kb1_bf16_forward_matches_pallas(flagship, n):
    """The plain bf16 forward (what mlp_train_fwd_bf16 runs on CPU tensors)
    against _fwd_call in interpret mode on pack_train(..., bfloat16)."""
    jparams, jls, model = flagship
    pts, vd = _points(n, 1)
    want = {dt: np.asarray(mlp_train_pallas._fwd_call(
        *mlp_train_pallas.pack_train(jparams, jls, dt), _ptsdir(pts, vd),
        interpret=True))[:n, :4] for dt in (BF16_J, jnp.float32)}
    T = M._layer_tensors(model)
    params, _pt, ls = M.pack_train(T[0::3], T[1::3], T[2::3])
    got, ws = M.mlp_train_fwd_bf16(params, ls, torch.from_numpy(pts),
                                   torch.from_numpy(vd), save_u=True)
    assert ws is None and got.shape == (n, 4)
    _within(got.numpy(), want[BF16_J], want[jnp.float32], f"raw n={n}",
            1 / 8, 1 / 2)


# (c) K-B1's bf16 backward ----------------------------------------------------
@pytest.fixture(scope="module")
def reference_vjp(flagship):
    """jax.vjp of fused_nerf_mlp_train with_dw (its _train_op, interpret
    mode) in bf16 and in float32, for a cotangent made with numpy: {dtype:
    (dls, {name: {"w", "b"}})}, and the bf16 one on REORDERINGS reordered
    sums (:func:`_reordered`). dls and db are the same computation with and
    without dW."""
    jparams, jls, _model = flagship
    n = mlp_train_pallas.TILE
    pts, vd = _points(n, 2)
    g = (1e-2 * np.random.default_rng(3).standard_normal((n, 4))) \
        .astype(np.float32)

    def vjp(dt, p, ls, order):
        cfg = jnerf.NeRFConfig(compute_dtype=dt)
        _raw, f = jax.vjp(
            lambda l, q: mlp_train_pallas.fused_nerf_mlp_train(
                q, l, jnp.asarray(pts[order]), jnp.asarray(vd[order]), cfg,
                with_dw=True), ls, p)
        return f(jnp.asarray(g[order]))

    out = {dt: vjp(dt, jparams, jls, slice(None))
           for dt in (BF16_J, jnp.float32)}
    spread = []
    for seed in range(REORDERINGS):
        p, ls, order, back = _reordered(jparams, jls, jnerf.NeRFConfig(), n,
                                        seed)
        spread.append(back(*vjp(BF16_J, p, ls, order)))
    return pts, vd, g, out, spread


@pytest.mark.parametrize("with_dw", [False, True])
def test_kb1_bf16_backward_matches_pallas(flagship, reference_vjp, with_dw):
    _jp, _jl, model = flagship
    pts, vd, g, want, spread = reference_vjp
    _train_all(model)
    raw = M.fused_nerf_mlp_train(model, torch.from_numpy(pts),
                                 torch.from_numpy(vd), with_dw=with_dw)
    raw.backward(torch.from_numpy(g))
    (l16, p16), (l32, p32) = want[BF16_J], want[jnp.float32]
    for name, layer in model.layers().items():
        _within(layer.weight_scaling.grad.numpy().ravel(), l16[name],
                l32[name], f"{name} ls", 1 / 3, 3 / 4,
                spread=[s[0][name] for s in spread])
        _within(layer.bias.grad.numpy(), p16[name]["b"], p32[name]["b"],
                f"{name} b", 1 / 3, 3 / 4,
                spread=[s[1][name]["b"] for s in spread])
        gw = layer.weight.grad.numpy().T
        if with_dw:
            # dW is rounded to bf16 on its way out, as the reference's
            assert not (gw.view(np.uint32) & 0xFFFF).any(), name
            _within(gw, p16[name]["w"], p32[name]["w"], f"{name} w", 1 / 3,
                    3 / 4, rounded=True,
                    spread=[s[1][name]["w"] for s in spread])
        else:
            assert np.abs(gw).max() == 0.0
    _train_all(model, weights=False)
    for layer in model.layers().values():
        layer.weight_scaling.requires_grad_(False)
        layer.bias.requires_grad_(False)


def test_two_pass_dw_bf16_plain_matches_pallas(flagship, reference_vjp):
    """The bf16 backward with dW in the kernels' two passes, plain: the
    first pass's bf16 du workspace, then X^T dU over blocks of DW_BLOCK
    points, the chunks' partials summed in order, dW rounded once summed,
    against jax.vjp's with dW (the Pallas _bwd_call's bf16 body in
    interpret mode) at K-B1's bars, and against the one-pass plain bf16
    version, from which it may differ by one bf16 step an element (the same
    exact products summed in another order, then rounded) and by float32
    reassociation, 1e-5 of the layer's largest element, where a sum cancels
    to a few ulps of its terms."""
    _jp, _jl, model = flagship
    pts, vd, g, want, spread = reference_vjp
    (_l16, p16), (_l32, p32) = want[BF16_J], want[jnp.float32]
    T = M._layer_tensors(model)
    params, params_t, ls = M.pack_train(T[0::3], T[1::3], T[2::3])
    tpts, tvd, tg = (torch.from_numpy(a) for a in (pts, vd, g))
    ws, du = M.train_workspaces_plain(params, params_t, ls, tpts, tvd, tg,
                                      bf16=True)
    assert torch.equal(du, mlp_fused.bf16_round(du))
    flat = M.mlp_train_dw_plain(ws, du, ls, M.gather_biases(params), tpts,
                                tvd, bf16=True, chunk=256)
    assert torch.equal(flat, mlp_fused.bf16_round(flat))
    one_pass = M.mlp_train_bwd_bf16_plain(params, params_t, ls, tpts, tvd,
                                          tg, True)[:M.WT_SIZE]
    dw, dw1 = (M.split_grads(torch.cat([f, f.new_zeros(2 * M.U_SIZE)]),
                             True)[0] for f in (flat, one_pass))
    for name in M.NAMES:
        beyond = (dw[name] - dw1[name]).abs() - 2.0 ** -7 * dw1[name].abs()
        assert float(beyond.max()) <= 1e-5 * float(dw1[name].abs().max()), \
            name
        _within(dw[name].numpy().T, p16[name]["w"], p32[name]["w"],
                f"{name} w", 1 / 3, 3 / 4, rounded=True,
                spread=[s[1][name]["w"] for s in spread])


def test_kb1_bf16_plain_versions_read_rounded_weights(flagship):
    """The plain bf16 versions on pack_train's float32 buffers equal the
    float32 chain on the rounded weights with the activations and every du
    rounded: what the wrappers hand the kernels is what they compute."""
    _jp, _jl, model = flagship
    T = M._layer_tensors(model)
    params, params_t, ls = M.pack_train(T[0::3], T[1::3], T[2::3])
    pr, ptr = M.round_weights_bf16(params, params_t)
    assert torch.equal(M.gather_biases(pr), M.gather_biases(params))
    fwd, bwd = M.pack_train_bf16(T[0::3])
    w_f, w_b = M.unpack_train_bf16(fwd, bwd)
    L = mlp_fused.unpack_weights(pr)
    for name in M.NAMES:
        assert torch.equal(w_f[name], L[name][0]), name
    pts, vd = (torch.from_numpy(a) for a in _points(300, 5))
    cot = 1e-2 * torch.randn(300, 4, generator=torch.Generator()
                             .manual_seed(6))
    r = mlp_fused.bf16_round
    assert torch.equal(M.mlp_train_fwd_bf16_plain(params, ls, pts, vd),
                       M.mlp_train_fwd_plain(pr, ls, pts, vd, rnd=r))
    flat = M.mlp_train_bwd_bf16_plain(params, params_t, ls, pts, vd, cot,
                                      True)
    assert torch.equal(flat, M.mlp_train_bwd_plain(pr, ptr, ls, pts, vd, cot,
                                                   True, rnd=r))
    without = M.mlp_train_bwd_bf16_plain(params, params_t, ls, pts, vd, cot,
                                         False)
    assert torch.equal(without, flat[M.WT_SIZE:])
    f32 = M.mlp_train_bwd_plain(params, params_t, ls, pts, vd, cot, False)
    assert float((without - f32).abs().max()) > 0


# (d) the two bf16 streams ----------------------------------------------------
def _halves(words):
    """(low, high) bf16 halves of int32 words as float64."""
    u = words.astype(np.int64) & 0xFFFFFFFF
    lo = ((u & 0xFFFF) << 16).astype(np.uint32).view(np.float32)
    hi = (u & 0xFFFF0000).astype(np.uint32).view(np.float32)
    return lo.astype(np.float64), hi.astype(np.float64)


def _fragment_product_bf16(words, slab0, k, x):
    """x (16, k) times the rows of a run of k / 16 k steps at 256 outputs
    (NT = 4), read with the index arithmetic of mma_run / PipeT
    (nerf_mlp_bf16.cuh): lane 4 g + t of warp w finds word r of n-tile nt
    at k step ks at slab * 8192 + w * 1024 + (ks % 4) * 256 + (nt // 2) *
    128 + lane * 4 + 2 (nt % 2) + r, and its low / high half multiplies
    channel 16 ks + 2 t + 8 r + {0, 1}."""
    out = np.zeros((x.shape[0], 256))
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for ks in range(k // 16):
        for warp in range(8):
            base = (slab0 + ks // 4) * 8192 + warp * 1024 + (ks % 4) * 256 \
                + lane * 4
            for nt in range(4):
                cols = warp * 32 + nt * 8 + g
                for r in range(2):
                    lo, hi = _halves(words[base + (nt // 2) * 128
                                           + 2 * (nt % 2) + r])
                    ch = 16 * ks + 2 * t + 8 * r
                    np.add.at(out, (slice(None), cols),
                              x[:, ch] * lo + x[:, ch + 1] * hi)
    return out


# (layer, first input column, du's width K, first slab): the schedule the
# bf16 backward's bwd_layer walks (kBwdSlabs = 34), 64 rows a slab
BWD_RUNS_BF16 = [("views_linears.0", 0, 128, 0),
                 ("feature_linear", 0, 256, 2)] + [
    (f"pts_linears.{i}", 63 if i == 5 else 0, 256, 6 + 4 * (7 - i))
    for i in range(7, 0, -1)]


def test_bf16_streams_round_trip_and_feed_the_fragments(flagship):
    """Both streams hold the unscaled weights rounded to bf16, read back bit
    for bit; the forward stream is K-B3 bf16's order of them (not
    pack_weights_bf16's, which folds the scales); the backward stream,
    read as bwd_layer's lanes read it, gives bf16(du) @ bf16(W)[:, cols]."""
    _jp, _jl, model = flagship
    weights = [w.detach() for w in M._layer_tensors(model)[0::3]]
    fwd, bwd = M.pack_train_bf16(weights)
    assert fwd.dtype == bwd.dtype == torch.int32
    assert fwd.shape == (mlp_fused.BF16_PARAMS_SIZE,)
    assert bwd.shape == (M.BWD_BF16_PARAMS_SIZE,) == (279168,)
    assert M.BWD_BF16_SLABS * mlp_fused.MMA_SLAB + 640 == 279168
    assert not torch.equal(fwd, mlp_fused.pack_weights_bf16(model))
    r = mlp_fused.bf16_round
    got_f, got_b = M.unpack_train_bf16(fwd, bwd)
    used = {"pts_linears.0": (0, 0), "pts_linears.5": (63, 319),
            "views_linears.0": (0, 256)}
    for name, w in zip(M.NAMES, weights):
        assert torch.equal(got_f[name].view(torch.int32),
                           r(w.t()).contiguous().view(torch.int32)), name
        lo, hi = used.get(name, (0, w.shape[1]))
        assert torch.equal(got_b[name][:, lo:hi], r(w)[:, lo:hi]), name
        rest = torch.cat([got_b[name][:, :lo], got_b[name][:, hi:]], 1)
        assert rest.numel() == 0 or float(rest.abs().max()) == 0.0, name
    index = M.BWD_BF16_SLAB_INDEX
    assert np.unique(index).size == index.size and index.max() < M.WT_SIZE
    tail = bwd[M.BWD_BF16_SLABS * mlp_fused.MMA_SLAB:].view(torch.float32)
    assert torch.equal(tail[:256], r(weights[9]).reshape(-1))
    assert torch.equal(tail[256:640].view(3, 128), r(weights[11]))
    assert [x[0] for x in BWD_RUNS_BF16] == [x[0] for x in M.BWD_RUNS]
    dims = dict(zip(M.NAMES, weights))
    words = bwd.numpy()
    rng = np.random.default_rng(4)
    for name, col0, k, slab0 in BWD_RUNS_BF16:
        w = r(dims[name]).numpy().astype(np.float64)
        du = r(torch.from_numpy(rng.standard_normal((16, k)))).numpy()
        np.testing.assert_allclose(
            _fragment_product_bf16(words, slab0, k, du),
            du @ w[:, col0:col0 + 256], rtol=0, atol=1e-12, err_msg=name)
    with pytest.raises(ValueError):
        M.unpack_train_bf16(fwd, bwd[:-1])
    with pytest.raises(ValueError):
        M.repack_bf16_t(torch.zeros(M.WT_SIZE - 1))


# (e) the pack cache's key ----------------------------------------------------
def test_train_packs_key_on_the_compute_type(flagship):
    _jp, _jl, model = flagship
    cache = M.TrainPackCache()
    w = M._layer_tensors(model)[0::3]
    f32 = cache.get(w)
    b16 = cache.get(w, BF16_T)
    assert (cache.hits, cache.misses) == (0, 2) and b16 is not f32
    assert cache.get(w, torch.float32) is f32
    assert cache.get(w, BF16_T) is b16
    assert (cache.hits, cache.misses) == (2, 2)
    assert all(torch.equal(a, b) for a, b in zip(f32, M.pack_train_wgmma(w)))
    assert all(torch.equal(a, b) for a, b in zip(b16, M.pack_train_bf16(w)))
    assert f32[0].dtype == torch.float32 and b16[0].dtype == torch.int32


# (f) LSA trajectories --------------------------------------------------------
def _jax_draws(key, R, rc):
    """The draws render_rays takes from ``key`` (renderer.py:119,
    sampling.py:28,54, volume.py:29), as torch tensors."""
    k_strat, k_pdf, k_n0, k_n1 = jax.random.split(key, 4)
    S = rc.n_samples + rc.n_importance
    t = lambda a: torch.from_numpy(np.array(a))
    return {"t_rand": t(jax.random.uniform(k_strat, (R, rc.n_samples))),
            "u": t(jax.random.uniform(k_pdf, (R, rc.n_importance))),
            "noise0": t(jax.random.normal(k_n0, (R, rc.n_samples))),
            "noise1": t(jax.random.normal(k_n1, (R, S)))}


def _jax_step_keys(n, seed=451):
    key, keys = jax.random.PRNGKey(seed), []
    for _ in range(n):
        key, sub = jax.random.split(key)
        keys.append(sub)
    return keys


HW = 16


@pytest.fixture(scope="module")
def scene():
    """A 16 x 16 inward scene of W=32 teachers, cameras at radius 1.2."""
    mlp = jnerf.NeRFConfig(W=32)
    rc = jrenderer.RenderConfig(mlp=mlp, n_samples=8, n_importance=4,
                                chunk=HW * HW)
    scene, teachers = jsynthetic.make_scene(n_images=3, H=HW, W=HW, mlp=mlp,
                                            rc=rc)
    scene["poses"] = scene["poses"].copy()
    scene["poses"][:, :3, 3] *= 0.3
    scene["near"], scene["far"] = 0.6, 1.8
    sd = jnerf.params_to_state_dict(teachers[0], "model.")
    sd.update(jnerf.params_to_state_dict(teachers[1], "model_fine."))
    return scene, sd


def _perturbed(sd, seed):
    rng = np.random.default_rng(seed)
    return {k: (np.asarray(v) * (1 + 0.05 * rng.standard_normal(
        np.shape(v))) if k.endswith(".weight") else np.asarray(v))
        .astype(np.float32) for k, v in sd.items()}


def _flagship_sd(seed):
    """A fog of the flagship architecture with 5% noise on every weight, as
    a state dict of both networks."""
    sd = {}
    for prefix, s in (("model.", seed), ("model_fine.", seed + 1)):
        p = jsynthetic._activate(jnerf.init_params(jax.random.PRNGKey(s),
                                                   jnerf.NeRFConfig()), s)
        sd.update(jnerf.params_to_state_dict(p, prefix))
    return _perturbed(sd, seed)


@pytest.mark.parametrize("fused", [False, True], ids=["xla", "kb1"])
def test_tune_lsa_trajectory_matches_jax(scene, fused):
    """Adam steps on the scales of a bf16 model, the same batches and JAX's
    keys replayed: through the folded form (W=32, four steps, 32 rays of
    16 + 16 samples) and through K-B1 (the flagship, two steps of 32 rays
    of 8 + 8 samples), against the reference's bf16 and float32 runs."""
    scene, sd = scene
    if fused:
        cfg_kw, sd, steps, n_rand, ns = {}, _flagship_sd(7), 2, 32, 8
    else:
        cfg_kw, sd, steps, n_rand, ns = dict(W=32), _perturbed(sd, 1), 4, \
            32, 16
    kw = dict(learning_rate=5e-3, learning_rate_decay=0.0, epochs=1,
              n_iters=steps)
    ex = {}
    for dt in (BF16_J, jnp.float32):
        rc = jpresets.make_render_config(
            scene, jnerf.NeRFConfig(**cfg_kw, compute_dtype=dt),
            chunk=HW * HW, use_fused_mlp=fused, n_samples=ns)
        rc = rc.__class__(**{**rc.__dict__, "n_importance": ns})
        ex[dt] = JExecuter(scene, rc, verbose=False, n_rand=n_rand, **kw)
    want = {}
    for dt, e in ex.items():
        pc, pf, lc, lf = e._split_params(sd)
        if lc is None:
            lc, lf = (jnerf.init_lsa_scales(e.rc.mlp) for _ in range(2))
        want[dt] = jlsa.tune_lsa_scales(
            pc, pf, lc, lf, e._make_batcher(), e.rc, scene["near"],
            scene["far"], seed=451, verbose=False, steps_per_call=1, **kw)
    ex_t = tpresets.create_nerf_model_executer(
        scene=scene, device="cpu", use_fused_mlp=fused, n_samples=ns,
        mlp_config=tnerf.NeRFConfig(**cfg_kw, compute_dtype=BF16_T),
        verbose=False, n_rand=n_rand, **kw)
    assert ex_t.rc.use_fused_train == fused
    ex_t.rc = ex_t.rc.__class__(**{**ex_t.rc.__dict__, "n_importance": ns})
    keys = _jax_step_keys(steps)
    mc, mf = ex_t._split_params(sd)
    got = tlsa.tune_lsa_scales(
        mc, mf, ex_t._make_batcher(), ex_t.rc, scene["near"], scene["far"],
        seed=451, verbose=False,
        draws=lambda i: _jax_draws(keys[i], n_rand, ex_t.rc), **kw)
    flat = lambda pair: np.concatenate([np.asarray(d[name]).ravel()
                                        for d in pair for name in sorted(d)])
    motion = flat(got[:2]) - 1
    w16, w32 = flat(want[BF16_J][:2]) - 1, flat(want[jnp.float32][:2]) - 1
    _within(motion, w16, w32, "scales", 1 / 2, 1)
    assert _rms(motion - w32) >= 2 * _rms(motion - w16)
    assert _rms(w16) > 4 * _rms(w16 - w32)
    assert got[4] == steps and abs(got[2] - want[BF16_J][2]) < 0.1


# (g) compression ------------------------------------------------------------
def test_compress_lsa_bf16_matches_jax_executer(scene, tmp_path, monkeypatch):
    """compress_model(lsa=True) of a bf16 model through the port's own
    executer (mlp_config) and, on the same batches with JAX's draws
    replayed, against the JAX executer: bitstreams that decode to the same
    tensors and layout, test PSNR within 0.1 dB."""
    scene, sd = scene
    sd = _perturbed(sd, 3)
    mlp_j = jnerf.NeRFConfig(W=32, compute_dtype=BF16_J)
    mlp_t = tnerf.NeRFConfig(W=32, compute_dtype=BF16_T)
    kw = dict(learning_rate=1e-2, epochs=1, n_iters=3, i_save=0, n_rand=32)
    ex_j = JExecuter(scene, jpresets.make_render_config(
        scene, mlp_j, chunk=HW * HW, n_samples=16), verbose=False, **kw)
    ex_t = tpresets.create_nerf_model_executer(
        scene=scene, device="cpu", mlp_config=mlp_t, n_samples=16,
        verbose=False, **kw)
    keys = _jax_step_keys(3)
    tune = tlsa.tune_lsa_scales
    monkeypatch.setattr(tlsa, "tune_lsa_scales", lambda *a, **k: tune(
        *a, draws=lambda i: _jax_draws(keys[i], 32, ex_t.rc), **k))
    bs_j, bs_t = str(tmp_path / "jax.nnc"), str(tmp_path / "torch.nnc")
    nnc_tpu.compress_model(sd, bitstream_path=bs_j, qp=-20, lsa=True,
                           model_executer=ex_j, verbose=False)
    nnc_tpu_torch.compress_model(sd, bitstream_path=bs_t, qp=-20, lsa=True,
                                 model_executer=ex_t, verbose=False)
    layout = []
    for bs in (bs_j, bs_t):
        with open(bs, "rb") as f:
            info, ad = coder.decode(f.read())
        layout.append((sorted(ad["parameters"]), info["block_identifier"]))
    assert layout[0] == layout[1]
    assert any(k.endswith(".weight_scaling") for k in layout[1][0])
    rec_j = nnc_tpu.decompress(bs_j, verbose=False)
    rec_t = nnc_tpu_torch.decompress(bs_t, verbose=False)
    assert set(rec_t) == set(rec_j) == set(sd)
    psnr_j, psnr_t = ex_j.test_model(rec_j), ex_t.test_model(rec_t)
    assert np.isfinite(psnr_t) and abs(psnr_t - psnr_j) < 0.1, \
        (psnr_t, psnr_j)
    # the port's own executer, made from mlp_config as the CLI makes it
    monkeypatch.undo()
    own = str(tmp_path / "own.nnc")
    nnc_tpu_torch.compress_model(
        sd, bitstream_path=own, qp=-20, lsa=True, scene=scene,
        mlp_config=mlp_t, n_samples=8, N_iters=1, epochs=1, i_save=0,
        N_rand=16, device="cpu", verbose=False)
    assert set(nnc_tpu_torch.decompress(own, verbose=False)) == set(sd)


# (h) the tool ---------------------------------------------------------------
def test_bench_train_step_on_the_cpu(capsys):
    before = _build.launch_counts()
    out = bench_train_step.main(["--device", "cpu", "--n_rand", "16",
                                 "--iters", "1", "--n_samples", "8",
                                 "--n_importance", "8", "--with_dw"])
    assert _build.launch_counts() == before
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split(":")[0] for line in lines] == ["plain", "fused"]
    for r in out.values():
        assert np.isfinite(r["loss"]) and r["ms"] > 0 and r["launches"] == {}
        assert len(r["ls0"]) == 3
    # one step from scales of one: both forms start at the same loss, and
    # the scales have moved by about the learning rate
    assert abs(out["plain"]["ls0"][0] - 1.0) > 1e-5
    assert abs(out["plain"]["ls0"][0] - out["fused"]["ls0"][0]) < 1e-4


# the other routes a float32 model tunes through ----------------------------
def test_bf16_tunes_over_a_mesh_jointly_and_by_fine_tuning(scene, tmp_path):
    """A bf16 flagship model through K-B1's bf16 form: two data-parallel LSA
    steps on a mesh of 2 x cpu equal the single-device steps on the same
    draws up to the order of the gradient sums (held at 1/8 of the distance
    to the float32 run of the same steps), and one scene through
    tune_multi_scene on a scene mesh is tune_lsa_scales; compress_model
    (fine_tune=True) of a bf16 model writes a bitstream that decodes."""
    from nnc_tpu_torch import parallel
    from nnc_tpu_torch.parallel import multi_scene
    scene, sd_small = scene
    sd = _flagship_sd(11)
    n_rand = 16
    g = torch.Generator().manual_seed(3)
    rc32 = trenderer.RenderConfig(n_samples=8, n_importance=8,
                                  use_fused_train=True)
    sets = [{"t_rand": torch.rand(n_rand, 8, generator=g),
             "u": torch.rand(n_rand, 8, generator=g)} for _ in range(2)]
    kw = dict(learning_rate=1e-2, learning_rate_decay=0.0, epochs=1,
              n_iters=2, seed=3, verbose=False, draws=lambda i: sets[i])

    def run(dtype, mesh=None):
        ex = tpresets.create_nerf_model_executer(
            scene=scene, device="cpu", use_fused_mlp=True, n_rand=n_rand,
            mlp_config=tnerf.NeRFConfig(compute_dtype=dtype), verbose=False)
        rc = rc32.__class__(**{**rc32.__dict__, "mlp": ex.rc.mlp})
        got = tlsa.tune_lsa_scales(*ex._split_params(sd), ex._make_batcher(),
                                   rc, scene["near"], scene["far"],
                                   mesh=mesh, **kw)
        return torch.cat([torch.cat(list(d.values())) for d in got[:2]])

    single, single32 = run(BF16_T), run(torch.float32)
    mesh = run(BF16_T, parallel.make_mesh(2, ("data",), devices=["cpu"]))
    dist = _rms((single - single32).numpy())
    assert dist > 0 and _rms((single - 1).numpy()) > 4 * dist
    assert _rms((mesh - single).numpy()) <= dist / 8

    ex = tpresets.create_nerf_model_executer(
        scene=scene, device="cpu", use_fused_mlp=True, n_rand=n_rand,
        mlp_config=tnerf.NeRFConfig(compute_dtype=BF16_T), verbose=False)
    rc = rc32.__class__(**{**rc32.__dict__, "mlp": ex.rc.mlp})
    (joint,), _ = multi_scene.tune_multi_scene(
        [scene], [ex._split_params(sd)], rc, batchers=[ex._make_batcher()],
        learning_rate=1e-2, n_iters=2, seeds=[3], verbose=False,
        mesh=multi_scene.make_scene_mesh(1, 1, devices=["cpu"]))
    alone = tlsa.tune_lsa_scales(
        *ex._split_params(sd), ex._make_batcher(), rc, scene["near"],
        scene["far"], learning_rate=1e-2, learning_rate_decay=0.0, epochs=1,
        n_iters=2, seed=3, verbose=False)
    for got, want in zip(joint, alone[:2]):
        for name in want:
            np.testing.assert_array_equal(got[name].numpy(),
                                          want[name].numpy(), err_msg=name)

    bs = str(tmp_path / "ft.nnc")
    nnc_tpu_torch.compress_model(
        _perturbed(sd_small, 4), bitstream_path=bs, qp=-20, lsa=False,
        fine_tune=True, scene=scene,
        mlp_config=tnerf.NeRFConfig(W=32, compute_dtype=BF16_T), n_samples=8,
        N_iters=2, epochs=1, i_save=0, N_rand=16, device="cpu", verbose=False)
    rec = nnc_tpu_torch.decompress(bs, verbose=False)
    assert set(rec) == set(sd_small)
