"""Render building blocks of nnc_tpu_torch against nnc_tpu (f32, CPU).

posenc, rays, NDC, stratified sampling (injected jitter), sample_pdf
(injected u and det), raw2outputs (injected noise): atol 1e-5. RayBatcher:
identical batches for the same seed.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from nnc_tpu.data.rays import RayBatcher as JRayBatcher
from nnc_tpu.ops import posenc as jposenc
from nnc_tpu.ops import sampling as jsampling
from nnc_tpu.render import rays as jrays
from nnc_tpu.render import volume as jvolume
from nnc_tpu_torch.data.rays import RayBatcher as TRayBatcher
from nnc_tpu_torch.ops import posenc as tposenc
from nnc_tpu_torch.ops import sampling as tsampling
from nnc_tpu_torch.render import rays as trays
from nnc_tpu_torch.render import volume as tvolume

ATOL = 1e-5


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("multires", [4, 10])
def test_positional_encoding(multires):
    x = np.random.default_rng(0).uniform(-2, 2, (7, 5, 3)).astype(np.float32)
    want = jposenc.positional_encoding(jnp.asarray(x), multires)
    got = tposenc.positional_encoding(torch.from_numpy(x), multires)
    assert got.shape == want.shape
    _close(got, want)


def _camera():
    K = np.array([[20.0, 0, 8.0], [0, 20.0, 6.0], [0, 0, 1]], np.float32)
    rng = np.random.default_rng(1)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    c2w = np.concatenate([q, rng.standard_normal((3, 1))], 1) \
        .astype(np.float32)
    return K, c2w


def test_get_rays_and_ndc():
    K, c2w = _camera()
    H, W = 12, 16
    ro_j, rd_j = jrays.get_rays(H, W, K, c2w)
    ro_t, rd_t = trays.get_rays(H, W, K, c2w)
    _close(ro_t, ro_j)
    _close(rd_t, rd_j)
    ro_n, rd_n = trays.get_rays_np(H, W, K, c2w)
    np.testing.assert_array_equal(ro_n, jrays.get_rays_np(H, W, K, c2w)[0])
    np.testing.assert_array_equal(rd_n, jrays.get_rays_np(H, W, K, c2w)[1])

    # NDC on forward-facing rays (camera looking down -z)
    c2w_ff = np.concatenate([np.eye(3), [[0.1], [-0.2], [0.05]]], 1) \
        .astype(np.float32)
    ro, rd = jrays.get_rays_np(H, W, K, c2w_ff)
    o_j, d_j = jrays.ndc_rays(H, W, 20.0, 1.0, jnp.asarray(ro),
                              jnp.asarray(rd))
    o_t, d_t = trays.ndc_rays(H, W, 20.0, 1.0, torch.from_numpy(ro),
                              torch.from_numpy(rd))
    _close(o_t, o_j)
    _close(d_t, d_j)


@pytest.mark.parametrize("lindisp", [False, True])
def test_stratified_samples_injected_jitter(lindisp):
    n_rays, n = 9, 16
    t_rand = np.random.default_rng(2).uniform(size=(n_rays, n)) \
        .astype(np.float32)
    # the JAX function draws its own jitter: reproduce it, then inject it
    key = jax.random.PRNGKey(5)
    want = jsampling.stratified_samples(key, 2.0, 6.0, n, n_rays, True,
                                        lindisp)
    jitter = np.array(jax.random.uniform(key, (n_rays, n)))
    got = tsampling.stratified_samples(2.0, 6.0, n, n_rays, True, lindisp,
                                       t_rand=torch.from_numpy(jitter))
    _close(got, want)
    got_det = tsampling.stratified_samples(2.0, 6.0, n, n_rays, False,
                                           lindisp)
    _close(got_det, jsampling.stratified_samples(key, 2.0, 6.0, n, n_rays,
                                                 False, lindisp))
    with_rand = tsampling.stratified_samples(2.0, 6.0, n, n_rays, True,
                                             lindisp,
                                             t_rand=torch.from_numpy(t_rand))
    assert torch.all(with_rand[:, 1:] >= with_rand[:, :-1])


@pytest.mark.parametrize("det", [True, False])
def test_sample_pdf_injected_u(det):
    rng = np.random.default_rng(3)
    R, B, N = 11, 14, 24
    bins = np.sort(rng.uniform(2, 6, (R, B + 1)), axis=-1).astype(np.float32)
    weights = rng.uniform(0, 1, (R, B)).astype(np.float32)
    weights[0] = 0.0            # an empty ray: uniform pdf
    weights[1, 3] = 50.0        # a peaked one
    key = jax.random.PRNGKey(7)
    want = jsampling.sample_pdf(key, jnp.asarray(bins), jnp.asarray(weights),
                                N, det)
    u = None
    if not det:
        u = torch.from_numpy(np.array(jax.random.uniform(key, (R, N))))
    got = tsampling.sample_pdf(torch.from_numpy(bins),
                               torch.from_numpy(weights), N, det, u=u)
    _close(got, want)


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_raw2outputs_injected_noise(white_bkgd):
    rng = np.random.default_rng(4)
    R, S = 13, 20
    raw = rng.standard_normal((R, S, 4)).astype(np.float32) * 2
    z = np.sort(rng.uniform(2, 6, (R, S)), axis=-1).astype(np.float32)
    rd = rng.standard_normal((R, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    want = jvolume.raw2outputs(jnp.asarray(raw), jnp.asarray(z),
                               jnp.asarray(rd), raw_noise_std=1.0,
                               white_bkgd=white_bkgd, noise_key=key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (R, S))))
    got = tvolume.raw2outputs(torch.from_numpy(raw), torch.from_numpy(z),
                              torch.from_numpy(rd), raw_noise_std=1.0,
                              white_bkgd=white_bkgd, noise=noise)
    for k in ("rgb_map", "acc_map", "weights"):
        _close(got[k], want[k])
    # depth sums w * z with z up to the far plane
    _close(got["depth_map"], want["depth_map"], atol=6 * ATOL)
    # no noise: the deterministic composite
    want0 = jvolume.raw2outputs(jnp.asarray(raw), jnp.asarray(z),
                                jnp.asarray(rd), white_bkgd=white_bkgd)
    got0 = tvolume.raw2outputs(torch.from_numpy(raw), torch.from_numpy(z),
                               torch.from_numpy(rd), white_bkgd=white_bkgd)
    _close(got0["rgb_map"], want0["rgb_map"])


@pytest.mark.parametrize("mode,precrop", [("image", 0), ("image", 2),
                                          ("pool", 0)])
def test_ray_batcher_identical_draws(mode, precrop):
    rng = np.random.default_rng(5)
    images = rng.uniform(size=(3, 6, 8, 3)).astype(np.float32)
    K, _ = _camera()
    poses = np.stack([_camera()[1]] * 3)
    args = (images, poses, K, np.array([0, 2]), 20)
    kw = dict(mode=mode, seed=451, precrop_iters=precrop)
    bj, bt = JRayBatcher(*args, **kw), TRayBatcher(*args, **kw)
    for _ in range(5):
        for a, b in zip(bj.next_batch(), bt.next_batch()):
            np.testing.assert_array_equal(a, b)
