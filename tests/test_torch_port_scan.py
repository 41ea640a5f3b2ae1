"""The multi-step LSA call of nnc_tpu_torch (train/lsa.py: call_lengths,
ScanTrainStep, tune_lsa_scales(steps_per_call=)) against nnc_tpu's (CPU).

  (a) the schedule of calls equals the one the reference's loop makes,
      read off that loop with its jitted steps replaced by recorders;
  (b) the port's K-step trajectory against the JAX package's
      ``steps_per_call=4`` run, with the reference's keys replayed in its
      grouping (``split(key)`` for a single step, ``split(key, k + 1)`` for
      a scan): scales to rtol 2e-4 / atol 2e-6 and the mean PSNR to 0.05 dB
      (tests/test_torch_port_train.py's bar), with the exact loss and with
      the occupancy loss on a small grid;
  (c) ``steps_per_call=8`` against ``=1`` on the port with the same seed:
      equal bit for bit, in float32 and bf16, with tuned biases, and on a
      resume whose learning-rate step falls inside a call;
  (d) one upload and one readback per call;
  the batcher's rays at the drawn pixels only, bit for bit today's and the
  JAX package's.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nnc_tpu.data import rays as jrays
from nnc_tpu.data import synthetic as jsynthetic
from nnc_tpu.models import nerf as jnerf
from nnc_tpu.render import occupancy as jocc
from nnc_tpu.render import renderer as jrenderer
from nnc_tpu.train import lsa as jlsa
from nnc_tpu_torch.data import rays as trays
from nnc_tpu_torch.models import nerf as tnerf
from nnc_tpu_torch.render import occupancy as tocc
from nnc_tpu_torch.render import renderer as trenderer
from nnc_tpu_torch.render.rays import get_rays_np
from nnc_tpu_torch.train import lsa as tlsa

MLP_J = jnerf.NeRFConfig(W=32)
MLP_T = tnerf.NeRFConfig(W=32)
R = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The port's steps here are tiny (16 rays, W = 32): one intra-op thread
    runs them as fast as several alone, and keeps them fast beside other
    test workers, where idle threads of many pools contend for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# (a) -----------------------------------------------------------------------
def _reference_calls(monkeypatch, epochs, n_iters, k, i_save, step0):
    """The reference loop's calls (k for a scan, 1 for a single step) and
    its save points, its jitted steps replaced by recorders."""
    calls, saves = [], []

    def single(*_a, **_k):
        def step(scales, opt_state, *_rest):
            calls.append(1)
            return scales, opt_state, 0.0, 1.0
        return step

    def scan(*_a, **_k):
        def step(scales, opt_state, _params, packed, *_rest):
            calls.append(packed.shape[0])
            n = packed.shape[0]
            return scales, opt_state, np.zeros(n), np.ones(n)
        return step

    monkeypatch.setattr(jlsa, "make_train_step", single)
    monkeypatch.setattr(jlsa, "make_scan_train_step", scan)
    ls = {"l": jnp.ones(2)}
    _ls_c, _ls_f, _p, _l, step, _b = jlsa.tune_lsa_scales(
        {}, {}, ls, ls, _Batches(2, 0), None, 2.0, 6.0, epochs=epochs,
        n_iters=n_iters, i_save=i_save, global_step0=step0,
        steps_per_call=k, verbose=False,
        save_hook=lambda s, *_a: saves.append(s))
    return calls, saves, step


@pytest.mark.parametrize("n_iters", [6, 20])
@pytest.mark.parametrize("step0", [0, 3])
@pytest.mark.parametrize("i_save", [0, 5, 7])
@pytest.mark.parametrize("k", [1, 4, 8])
def test_call_lengths_match_reference_loop(monkeypatch, k, i_save, step0,
                                           n_iters):
    want, want_saves, end = _reference_calls(monkeypatch, 2, n_iters, k,
                                             i_save, step0)
    got = tlsa.call_lengths(2, n_iters, k, i_save, step0)
    assert [sum(e) for e in got] == [n_iters, n_iters]
    assert [c for e in got for c in e] == want
    steps = np.cumsum([c for e in got for c in e]) + step0
    saves = [s for s in steps if i_save and (s == 1 or s % i_save == 0)]
    assert saves == want_saves and steps[-1] == end


# (b) -----------------------------------------------------------------------
def _batch(n, seed):
    rng = np.random.default_rng(seed)
    ro = (0.1 * rng.standard_normal((n, 3)) + [0, 0, 4.0]).astype(np.float32)
    rd = (0.2 * rng.standard_normal((n, 3)) + [0, 0, -1.0]) \
        .astype(np.float32)
    vd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    tgt = rng.uniform(size=(n, 3)).astype(np.float32)
    return ro, rd, vd, tgt


class _Batches:
    """The same ray batches, from a seed, for both packages."""

    def __init__(self, n, seed):
        self.n, self.seed = n, seed

    def next_batch(self):
        self.seed += 1
        return _batch(self.n, self.seed)


def _reference_keys(schedule, seed=451):
    """Each step's key as the reference's loop splits them: ``split(key)``
    for a single step, ``split(key, k + 1)`` for a scan of k."""
    key, keys = jax.random.PRNGKey(seed), []
    for k in (c for epoch in schedule for c in epoch):
        if k == 1:
            key, sub = jax.random.split(key)
            keys.append(sub)
        else:
            key, *subs = jax.random.split(key, k + 1)
            keys += subs
    return keys


def _jax_draws(key, rc):
    """The draws render_rays takes from ``key`` (renderer.py:119,
    sampling.py:28,54, volume.py:29), as torch tensors."""
    k_strat, k_pdf, k_n0, k_n1 = jax.random.split(key, 4)
    S = rc.n_samples + rc.n_importance
    t = lambda a: torch.from_numpy(np.array(a))
    return {"t_rand": t(jax.random.uniform(k_strat, (R, rc.n_samples))),
            "u": t(jax.random.uniform(k_pdf, (R, rc.n_importance))),
            "noise0": t(jax.random.normal(k_n0, (R, rc.n_samples))),
            "noise1": t(jax.random.normal(k_n1, (R, S)))}


def _occ_draws(key, budget):
    """The raw noise double_mse_loss_occ takes from ``key`` (lsa.py:89,
    volume.py:29)."""
    k_c, k_f = jax.random.split(key)
    t = lambda k: torch.from_numpy(np.array(jax.random.normal(k, (R,
                                                                  budget))))
    return {"noise0": t(k_c), "noise1": t(k_f)}


def _nets(seed, dtype=torch.float32):
    """Two activated W=32 nets with LSA scales 1 +- 0.05: the JAX (params,
    ls) pytrees and the port's models of them."""
    nets, models = [], []
    for i in range(2):
        p = jax.tree.map(np.asarray, jsynthetic._activate(
            jnerf.init_params(jax.random.PRNGKey(seed + i), MLP_J), seed + i))
        rng = np.random.default_rng(seed + 10 + i)
        ls = {n: (1.0 + 0.05 * rng.standard_normal(q["b"].shape[0]))
              .astype(np.float32) for n, q in p.items()}
        nets.append((jax.tree.map(jnp.asarray, p),
                     {k: jnp.asarray(v) for k, v in ls.items()}))
        models.append(tnerf.from_jax_params(
            p, tnerf.NeRFConfig(W=32, compute_dtype=dtype), ls=ls))
    return nets, models


@pytest.fixture(scope="module")
def solid_grid():
    """The reference's occupancy grid (res 16) of a solid sphere."""
    cfg = jnerf.NeRFConfig()
    params = jsynthetic.make_solid_mlp(cfg, radius=1.0, density=80.0)
    return jocc.build_occupancy_grid(params, None, cfg, res=16,
                                     use_fused=False, chunk=32768)


@pytest.mark.parametrize("loss", ["exact", "occupancy"])
def test_scan_trajectory_matches_jax(loss, solid_grid):
    """tune_lsa_scales(steps_per_call=4, epochs=2, n_iters=6, i_save=5) in
    both packages: calls [1, 4, 1] and [4, 1, 1], the lr halving after 6."""
    nets, models = _nets(8)
    kw = dict(n_samples=32, n_importance=32, raw_noise_std=1.0)
    if loss == "occupancy":
        kw = dict(n_samples=64, n_importance=0, perturb=False,
                  raw_noise_std=1.0)
    rc_j = jrenderer.RenderConfig(mlp=MLP_J, **kw)
    rc_t = trenderer.RenderConfig(mlp=MLP_T, **kw)
    run = dict(learning_rate=5e-3, learning_rate_decay=0.5, epochs=2,
               n_iters=6, i_save=5, seed=451, verbose=False,
               steps_per_call=4)
    occ_j = occ_t = {}
    if loss == "occupancy":
        occ_j = dict(grid=solid_grid, occ_candidates=32, occ_budget=8)
        occ_t = dict(occ_j, grid=tocc.grid_from_arrays(
            np.asarray(solid_grid.occ), solid_grid.lo, solid_grid.hi,
            solid_grid.occ_lo, solid_grid.occ_hi, solid_grid.open_boundary))
    saves_j, saves_t = [], []
    want = jlsa.tune_lsa_scales(
        nets[0][0], nets[1][0], nets[0][1], nets[1][1], _Batches(R, 0),
        rc_j, 2.0, 6.0, save_hook=lambda s, *_a: saves_j.append(s),
        **occ_j, **run)
    schedule = tlsa.call_lengths(2, 6, 4, 5)
    assert schedule == [[1, 4, 1], [4, 1, 1]]
    keys = _reference_keys(schedule)
    draws = (lambda i: _jax_draws(keys[i], rc_t)) if loss == "exact" \
        else (lambda i: _occ_draws(keys[i], 8))
    got = tlsa.tune_lsa_scales(
        *models, _Batches(R, 0), rc_t, 2.0, 6.0, draws=draws,
        save_hook=lambda s, *_a: saves_t.append(s), **occ_t, **run)
    assert got[4] == want[4] == 12 and saves_t == saves_j == [1, 5, 10]
    moved = 0.0
    for g_ls, w_ls in zip(got[:2], want[:2]):
        for name in w_ls:
            w = np.asarray(w_ls[name])
            moved = max(moved, np.abs(w - 1).max())
            np.testing.assert_allclose(g_ls[name].numpy(), w, rtol=2e-4,
                                       atol=2e-6, err_msg=name)
    assert moved > 5e-2
    assert abs(got[2] - want[2]) < 0.05


# (c) -----------------------------------------------------------------------
def _tune(steps_per_call, dtype, tune_biases=False, **kw):
    """The trained tensors after the run, flat, how far they moved, and
    (mean PSNR, mean loss, global step)."""
    g = torch.Generator().manual_seed(3)
    cfg = tnerf.NeRFConfig(W=32, compute_dtype=dtype)
    models = [tnerf.init_lsa_scales(tnerf.init_params(cfg, g), std=0.05,
                                    generator=g) for _ in range(2)]
    rc = trenderer.RenderConfig(mlp=models[0].config, n_samples=8,
                                n_importance=8, raw_noise_std=0.5)
    start = torch.cat([t.detach().reshape(-1).clone()
                       for t in tlsa.trained_tensors(*models, True,
                                                     tune_biases)])
    out = tlsa.tune_lsa_scales(
        *models, _Batches(R, 0), rc, 2.0, 6.0, learning_rate=1e-2,
        learning_rate_decay=0.5, verbose=False, tune_biases=tune_biases,
        steps_per_call=steps_per_call, seed=3, **kw)
    flat = torch.cat([v for part in out[:2] + (out[5] or ())
                      for v in part.values()])
    return flat, float((flat - start).abs().max()), out[2:5]


def _state_at(step, dtype, tune_biases):
    """The optimizer state a 10-step run saved after ``step`` steps."""
    seen = {}
    _tune(1, dtype, tune_biases, epochs=1, n_iters=10, i_save=step,
          save_hook=lambda s, _c, _f, st: seen.setdefault(s, st))
    return seen[step]


@pytest.mark.parametrize("case", ["fresh", "resume", "resume_opt_state"])
@pytest.mark.parametrize("tune_biases", [False, True],
                         ids=["scales", "scales_biases"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
def test_eight_steps_a_call_equal_one(dtype, tune_biases, case):
    """steps_per_call 8 and 1 on the same seed give the same bits. The
    resumes start at step 5 of epochs of 10 steps, so the learning rate
    halves at the sixth step of the first call of 8: by the schedule's
    offset without a saved state, by the saved count with one."""
    kw = dict(epochs=1, n_iters=20)
    if case != "fresh":
        kw = dict(epochs=1, n_iters=10, global_step0=5)
        assert tlsa.call_lengths(1, 10, 8, 0, 5) == [[8, 1, 1]]
    if case == "resume_opt_state":
        kw["opt_state0"] = _state_at(5, dtype, tune_biases)
        assert kw["opt_state0"]["count"] == 5
    one, moved, stats1 = _tune(1, dtype, tune_biases, **kw)
    eight, _moved, stats8 = _tune(8, dtype, tune_biases, **kw)
    assert torch.equal(one, eight)
    assert stats1 == stats8
    assert moved > 1e-2


def test_adam_is_optax_adam():
    """Adam's update against optax.adam on the same gradients, the learning
    rate changing from step to step: rtol 1e-6."""
    import optax
    rng = np.random.default_rng(0)
    shapes = [(5, 1), (7,), (3, 1)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    trained = [torch.tensor(p) for p in params]
    adam = tlsa.Adam(trained)
    lrs = [1e-2, 1e-2, 5e-3, 5e-3, 2.5e-3]
    opt = optax.adam(lambda c: jnp.asarray(lrs)[c], b1=0.9, b2=0.999,
                     eps=1e-8)
    jp = [jnp.asarray(p) for p in params]
    state = opt.init(jp)
    for count, lr in enumerate(lrs):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        upd, state = opt.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        adam.update([torch.tensor(g) for g in grads],
                    torch.from_numpy(tlsa.Adam.hyper(lr, count)))
    for got, want in zip(trained, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    st = adam.state_dict()
    back = tlsa.Adam([torch.zeros(s) for s in shapes])
    back.load_state_dict(st)
    assert torch.equal(back.m, adam.m) and torch.equal(back.v, adam.v)
    assert tlsa.opt_state_fits({"count": 5, "adam": st}, trained)


# (d) -----------------------------------------------------------------------
def test_one_upload_and_one_readback_per_call(monkeypatch):
    seen = {"up": [], "back": []}
    upload, readback = tlsa._upload, tlsa._readback
    monkeypatch.setattr(tlsa, "_upload", lambda host, *a, **k: (
        seen["up"].append(host.size), upload(host, *a, **k))[1])
    monkeypatch.setattr(tlsa, "_readback", lambda t: (
        seen["back"].append(tuple(t.shape)), readback(t))[1])
    stats = {}
    _tune(8, torch.float32, epochs=2, n_iters=12, i_save=10, stats=stats)
    calls = [k for e in tlsa.call_lengths(2, 12, 8, 10) for k in e]
    assert calls == [1, 8, 1, 1, 1, 8, 1, 1, 1, 1]
    assert [c[0] for c in stats["calls"]] == calls
    assert seen["back"] == [(k, 2) for k in calls]
    assert seen["up"] == [k * (R * 12 + 3) for k in calls]


# the batcher ---------------------------------------------------------------
@pytest.mark.parametrize("precrop_iters", [0, 20])
def test_batcher_rays_at_drawn_pixels(precrop_iters):
    """50 "image" batches: bit for bit the JAX package's batcher, and the
    rays of the whole image (get_rays_np) at the pixels drawn."""
    rng = np.random.default_rng(0)
    H, W, n = 12, 20, 64
    images = rng.uniform(size=(3, H, W, 3)).astype(np.float32)
    poses = jsynthetic.look_at_poses(3, seed=1)
    K = np.array([[17.0, 0, W / 2], [0, 17.0, H / 2], [0, 0, 1]], np.float32)
    kw = dict(n_rand=n, seed=4, precrop_iters=precrop_iters)
    got = trays.RayBatcher(images, poses, K, [0, 1, 2], **kw)
    want = jrays.RayBatcher(images, poses, K, [0, 1, 2], **kw)
    twin = np.random.default_rng(4)   # the batcher's draws, replayed
    for step in range(50):
        g, w = got.next_batch(), want.next_batch()
        for a, b in zip(g, w):
            assert a.dtype == np.float32 and np.array_equal(a, b)
        img = twin.choice([0, 1, 2])
        if step < precrop_iters:
            dH, dW = H // 4, W // 4
            sel = twin.choice(4 * dH * dW, size=min(n, 4 * dH * dW),
                              replace=False)
            ys = H // 2 - dH + sel // (2 * dW)
            xs = W // 2 - dW + sel % (2 * dW)
        else:
            sel = twin.choice(H * W, size=n, replace=False)
            ys, xs = sel // W, sel % W
        ro, rd = get_rays_np(H, W, K, np.asarray(poses, np.float32)
                             [img, :3, :4])
        for a, b in zip(g, (ro[ys, xs], rd[ys, xs], images[img][ys, xs])):
            assert np.array_equal(a, b)
