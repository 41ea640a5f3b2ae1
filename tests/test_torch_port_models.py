"""nnc_tpu_torch.models.nerf against nnc_tpu.models.nerf (f32, CPU).

Same numpy-seeded weights, LSA scales and inputs through both; the MLP must
agree at rtol 1e-4 / atol 1e-5 (float32 matmuls summed in another order).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nnc_tpu.models import nerf as jnerf
from nnc_tpu_torch.models import nerf as tnerf


def _numpy_params(cfg_j, seed, ls_std=0.0):
    rng = np.random.default_rng(seed)
    params, ls = {}, {}
    for name, (din, dout) in jnerf._layer_dims(cfg_j).items():
        bound = 1.0 / np.sqrt(din)
        params[name] = {
            "w": rng.uniform(-bound, bound, (din, dout)).astype(np.float32),
            "b": rng.uniform(-bound, bound, (dout,)).astype(np.float32)}
        ls[name] = (1.0 + ls_std * rng.standard_normal(dout)) \
            .astype(np.float32)
    return params, ls


def _configs(W):
    return jnerf.NeRFConfig(W=W), tnerf.NeRFConfig(W=W)


@pytest.mark.parametrize("W", [32, 256])
def test_apply_mlp_matches_jax_with_lsa(W):
    cfg_j, cfg_t = _configs(W)
    params, ls = _numpy_params(cfg_j, seed=W, ls_std=0.1)
    rng = np.random.default_rng(1)
    pe = rng.standard_normal((96, 63)).astype(np.float32)
    ve = rng.standard_normal((96, 27)).astype(np.float32)

    want = np.asarray(jnerf.apply_mlp(
        {k: {kk: jnp.asarray(vv) for kk, vv in v.items()}
         for k, v in params.items()},
        jnp.asarray(pe), jnp.asarray(ve), cfg_j,
        ls={k: jnp.asarray(v) for k, v in ls.items()}))
    model = tnerf.from_jax_params(params, cfg_t, ls=ls)
    with torch.no_grad():
        got = tnerf.apply_mlp(model, torch.from_numpy(pe),
                              torch.from_numpy(ve)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    # folding the scales into the weights leaves the forward unchanged
    folded = tnerf.fold_lsa(model)
    assert not any(k.endswith("weight_scaling") for k in folded.state_dict())
    with torch.no_grad():
        got_f = folded(torch.from_numpy(pe), torch.from_numpy(ve)).numpy()
    np.testing.assert_allclose(got_f, want, rtol=1e-4, atol=1e-5)


def test_state_dict_layout_matches_jax_converters():
    """The module's state dict is the codec's layout: the JAX package's
    params_to_state_dict of the same weights, key for key and bit for bit,
    and it reads back through both packages' params_from_state_dict."""
    cfg_j, cfg_t = _configs(32)
    params, ls = _numpy_params(cfg_j, seed=3, ls_std=0.05)
    want = jnerf.params_to_state_dict(params, "model.", ls)
    model = tnerf.from_jax_params(params, cfg_t, ls=ls)
    got = tnerf.params_to_state_dict(model, "model.")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])

    back = tnerf.params_from_state_dict(want, "model.", cfg_t)
    for k, v in tnerf.params_to_state_dict(back, "model.").items():
        np.testing.assert_array_equal(v, want[k])
    assert tnerf.config_from_state_dict(want, "model.") == cfg_t


@pytest.mark.parametrize("sd_kind", ["flagship", "no_viewdirs"])
def test_config_from_state_dict_matches_jax(sd_kind):
    if sd_kind == "flagship":
        cfg_j = jnerf.NeRFConfig()
    else:
        cfg_j = jnerf.NeRFConfig(D=4, W=16, skips=(1,), use_viewdirs=False)
    params, _ = _numpy_params(cfg_j, seed=0)
    sd = jnerf.params_to_state_dict(params, "model_fine.")
    cj = jnerf.config_from_state_dict(sd, "model_fine.")
    ct = tnerf.config_from_state_dict(sd, "model_fine.")
    for f in ("D", "W", "input_ch", "input_ch_views", "output_ch", "skips",
              "use_viewdirs"):
        assert getattr(ct, f) == getattr(cj, f), f


def test_init_params_and_lsa_scales():
    cfg = tnerf.NeRFConfig(W=32)
    a = tnerf.init_params(cfg, torch.Generator().manual_seed(4))
    b = tnerf.init_params(cfg, torch.Generator().manual_seed(4))
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    for name, (din, dout) in tnerf._layer_dims(cfg).items():
        w = a.get_submodule(name).weight.detach()
        assert w.shape == (dout, din)
        assert float(w.abs().max()) <= 1.0 / np.sqrt(din)
    assert not any(k.endswith("weight_scaling") for k in a.state_dict())
    tnerf.init_lsa_scales(a, std=1e-5, generator=torch.Generator()
                          .manual_seed(0))
    sd = a.state_dict()
    assert sd["pts_linears.0.weight_scaling"].shape == (32, 1)
    scales = torch.cat([v.reshape(-1) for k, v in sd.items()
                        if k.endswith("weight_scaling")])
    assert float((scales - 1).abs().max()) < 1e-4
