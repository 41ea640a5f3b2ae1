"""NeRF MLP as a PyTorch module with first-class LSA scales.

Counterpart of ``nnc_tpu/models/nerf.py``. The module's ``state_dict()``
uses the codec's keys (``pts_linears.{i}.weight`` (out, in), ``.bias``),
so a wrapper checkpoint's ``model.*`` / ``model_fine.*`` entries load
directly. LSA ("Local Scaling Adaptation") attaches one scale per output
channel to every linear layer as a ``weight_scaling`` buffer of shape
(out, 1); the effective weight is ``weight_scaling * weight``, as in the
reference's ScaledLinear (framework/applications/utils/transforms.py:84-111).

Architecture (D=8, W=256, skip at layer 4, viewdir head):
  pts_linears: 63 -> 256 -> ... (skip concat at layer index 4 output) -> 256
  alpha_linear: 256 -> 1 ; feature_linear: 256 -> 256
  views_linears[0]: 256+27 -> 128 ; rgb_linear: 128 -> 3

``NeRFConfig.compute_dtype`` is the type of the products' operands:
float32, or bfloat16 (the reference's ``compute_dtype=jnp.bfloat16``), in
which every layer rounds its input and its effective weight to bf16, sums the
products in float32 and adds its float32 bias (``apply_mlp``'s ``dense``,
nnc_tpu/models/nerf.py:110-116). Parameters, biases and outputs are float32
either way.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class NeRFConfig:
    D: int = 8
    W: int = 256
    input_ch: int = 63
    input_ch_views: int = 27
    output_ch: int = 4
    skips: tuple = (4,)
    use_viewdirs: bool = True
    compute_dtype: torch.dtype = torch.float32   # or torch.bfloat16

    def __post_init__(self):
        if self.compute_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute_dtype must be torch.float32 or "
                             f"torch.bfloat16, got {self.compute_dtype}")


# mip-NeRF's one MLP (Barron et al., ICCV 2021; github.com/google/mip-nerf
# internal/models.py MLP with configs/blender.gin): the same twelve layers,
# fed by the integrated positional encoding of a frustum (16 frequencies x
# (sin, cos) x 3, no identity) and posenc 4 of the view direction.
MIPNERF = NeRFConfig(input_ch=96, input_ch_views=27)


def _mip_orders():
    """(IPE_FROM_MIP, VIEWS_FROM_MIP): for each of the port's input channels
    the index of the same channel in mip-NeRF's order. The port orders
    frequency by frequency, [sin (3), cos (3)] each (posenc's order); mip-NeRF
    puts every sine first, frequency-major ([sin (16 x 3), cos (16 x 3)]),
    and its view encoding as [x, sin (4 x 3), cos (4 x 3)]."""
    ipe = [48 * k + 3 * l + d for l in range(16) for k in range(2)
           for d in range(3)]
    views = [0, 1, 2] + [3 + 12 * k + 3 * f + d for f in range(4)
                         for k in range(2) for d in range(3)]
    return np.asarray(ipe), np.asarray(views)


IPE_FROM_MIP, VIEWS_FROM_MIP = _mip_orders()


def layer_names(config: NeRFConfig):
    """Module names of the linear layers of one NeRF MLP, in forward order."""
    names = [f"pts_linears.{i}" for i in range(config.D)]
    if config.use_viewdirs:
        names += ["feature_linear", "alpha_linear", "views_linears.0",
                  "rgb_linear"]
    else:
        names += ["output_linear"]
    return names


def _layer_dims(config: NeRFConfig):
    """{layer name: (in, out)}."""
    dims = {}
    in_dim = config.input_ch
    for i in range(config.D):
        dims[f"pts_linears.{i}"] = (in_dim, config.W)
        in_dim = config.W + (config.input_ch if i in config.skips else 0)
    if config.use_viewdirs:
        dims["feature_linear"] = (config.W, config.W)
        dims["alpha_linear"] = (config.W, 1)
        dims["views_linears.0"] = (config.W + config.input_ch_views,
                                   config.W // 2)
        dims["rgb_linear"] = (config.W // 2, 3)
    else:
        dims["output_linear"] = (config.W, config.output_ch)
    return dims


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest, ties to even, as ``astype``) and
    held as float32 again."""
    return x.to(torch.bfloat16).to(torch.float32)


class Linear(nn.Module):
    """Linear layer (torch layout: weight (out, in)) with an optional LSA
    scale buffer ``weight_scaling`` (out, 1), absent until attached."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__()
        self.weight = nn.Parameter(
            torch.zeros(out_features, in_features, device=device))
        self.bias = nn.Parameter(torch.zeros(out_features, device=device))
        self.register_buffer("weight_scaling", None)

    def effective_weight(self) -> torch.Tensor:
        if self.weight_scaling is None:
            return self.weight
        return self.weight * self.weight_scaling

    def forward(self, x, output_scaling: bool = False,
                compute_dtype: torch.dtype = torch.float32):
        """``x @ (ls * W)^T + b``; with ``output_scaling`` the same as
        ``(x @ W^T) * ls + b``, whose autograd takes the scale gradient from
        the unscaled product instead of a full (out, in) weight gradient
        (training renders; mlp_train_pallas.py:108-110).

        With ``compute_dtype`` bfloat16 the input and the effective weight
        (the scale folded in float32 first) are rounded to bf16, to nearest
        even, and multiplied as float32: a product of two bf16 values is
        exact in float32 (and in TF32, so the card's TF32 switch cannot
        change it), the sum is float32, the bias is added in float32.
        ``F.linear`` on bf16 tensors would round the sum to bf16 instead.
        That is the reference's one bf16 form of the plain MLP, for
        inference and training alike (nnc_tpu/models/nerf.py:110-116), so
        ``output_scaling`` changes nothing in bf16. Its gradients are
        autograd's, which pass a cotangent through each rounding as JAX's
        transpose of ``astype`` does: the cotangents of the rounded input
        and of the rounded weight are themselves rounded to bf16."""
        if compute_dtype == torch.bfloat16:
            return F.linear(bf16_round(x), bf16_round(self.effective_weight()),
                            self.bias)
        if output_scaling and self.weight_scaling is not None:
            return F.linear(x, self.weight) * self.weight_scaling.reshape(-1) \
                + self.bias
        return F.linear(x, self.effective_weight(), self.bias)


class NeRF(nn.Module):
    def __init__(self, config: NeRFConfig = NeRFConfig(), device=None):
        super().__init__()
        self.config = config
        dims = _layer_dims(config)
        self.pts_linears = nn.ModuleList(
            Linear(*dims[f"pts_linears.{i}"], device=device)
            for i in range(config.D))
        if config.use_viewdirs:
            self.feature_linear = Linear(*dims["feature_linear"], device=device)
            self.alpha_linear = Linear(*dims["alpha_linear"], device=device)
            self.views_linears = nn.ModuleList(
                [Linear(*dims["views_linears.0"], device=device)])
            self.rgb_linear = Linear(*dims["rgb_linear"], device=device)
        else:
            self.output_linear = Linear(*dims["output_linear"], device=device)

    def layers(self) -> Dict[str, Linear]:
        """{layer name: Linear} in forward order."""
        return {name: self.get_submodule(name)
                for name in layer_names(self.config)}

    @property
    def device(self) -> torch.device:
        return self.pts_linears[0].weight.device

    def forward(self, pts_emb, views_emb=None, output_scaling: bool = False):
        """pts_emb: (..., input_ch); views_emb: (..., input_ch_views).
        Returns raw (..., 4) = (rgb logits, sigma), float32 whatever
        ``config.compute_dtype``. ``output_scaling``: see
        :meth:`Linear.forward`."""
        cfg = self.config
        how = (output_scaling, cfg.compute_dtype)
        h = pts_emb
        for i, layer in enumerate(self.pts_linears):
            h = F.relu(layer(h, *how))
            if i in cfg.skips:
                h = torch.cat([pts_emb, h], dim=-1)
        if cfg.use_viewdirs:
            alpha = self.alpha_linear(h, *how)
            feature = self.feature_linear(h, *how)
            h = torch.cat([feature, views_emb], dim=-1)
            h = F.relu(self.views_linears[0](h, *how))
            rgb = self.rgb_linear(h, *how)
            return torch.cat([rgb, alpha], dim=-1)
        return self.output_linear(h, *how)


def init_params(config: NeRFConfig = NeRFConfig(),
                generator: Optional[torch.Generator] = None,
                device=None) -> NeRF:
    """Uniform(-1/sqrt(in), 1/sqrt(in)) init of every weight and bias (the
    scale of torch's nn.Linear default), drawn from ``generator`` on the CPU
    and moved to ``device``."""
    model = NeRF(config)
    with torch.no_grad():
        for layer in model.layers().values():
            bound = 1.0 / np.sqrt(layer.weight.shape[1])
            for p in (layer.weight, layer.bias):
                p.copy_(torch.rand(p.shape, generator=generator)
                        * (2 * bound) - bound)
    return model.to(device)


def init_lsa_scales(model: NeRF, std: float = 1e-5,
                    generator: Optional[torch.Generator] = None) -> NeRF:
    """Attach one scale per output channel to every layer, N(1, std^2) when a
    generator is given, else exactly 1 (reference: transforms.py:97-101).
    Modifies ``model`` in place and returns it."""
    for layer in model.layers().values():
        out = layer.weight.shape[0]
        noise = torch.zeros(out, 1)
        if generator is not None:
            noise = std * torch.randn(out, 1, generator=generator)
        layer.weight_scaling = (1.0 + noise).to(layer.weight.device)
    return model


def apply_mlp(model: NeRF, pts_emb, views_emb=None,
              output_scaling: bool = False):
    """Forward the MLP on embedded points (+ embedded view dirs)."""
    return model(pts_emb, views_emb, output_scaling)


def fold_lsa(model: NeRF) -> NeRF:
    """A copy of ``model`` with its LSA scales baked into the weights."""
    out = NeRF(model.config, device=model.device)
    with torch.no_grad():
        for src, dst in zip(model.layers().values(),
                            out.layers().values()):
            dst.weight.copy_(src.effective_weight())
            dst.bias.copy_(src.bias)
    return out


# ---------------------------------------------------------------------------
# codec state-dict layout
# ---------------------------------------------------------------------------
def config_from_state_dict(state_dict: Mapping[str, np.ndarray],
                           prefix: str = "model.") -> NeRFConfig:
    """Infer D/W/skips/viewdirs from a flat torch-layout state dict
    (``compute_dtype`` is no property of a checkpoint: float32, the
    default)."""
    pts = sorted(int(k[len(prefix) + 12:-7]) for k in state_dict
                 if k.startswith(prefix + "pts_linears.")
                 and k.endswith(".weight"))
    if not pts:
        raise KeyError(f"no '{prefix}pts_linears.*.weight' keys")
    D = max(pts) + 1
    W, input_ch = np.shape(state_dict[prefix + "pts_linears.0.weight"])
    skips = tuple(
        i for i in range(D - 1)
        if np.shape(state_dict[prefix + f"pts_linears.{i + 1}.weight"])[1]
        == W + input_ch)
    use_viewdirs = (prefix + "alpha_linear.weight") in state_dict
    input_ch_views = 0
    output_ch = 4
    if use_viewdirs:
        input_ch_views = int(np.shape(
            state_dict[prefix + "views_linears.0.weight"])[1]) - W
    else:
        output_ch = int(np.shape(state_dict[prefix + "output_linear.weight"])[0])
    return NeRFConfig(D=D, W=int(W), input_ch=int(input_ch),
                      input_ch_views=input_ch_views, output_ch=output_ch,
                      skips=skips, use_viewdirs=use_viewdirs)


def params_from_state_dict(state_dict: Mapping[str, np.ndarray], prefix: str,
                           config: NeRFConfig, device=None) -> NeRF:
    """Build a NeRF from a flat numpy state dict with torch layout.

    Keys: ``{prefix}{layer}.weight`` (out, in), ``.bias`` (out,), optional
    ``.weight_scaling`` (out,) or (out, 1), which become LSA buffers."""
    model = NeRF(config, device=device)
    with torch.no_grad():
        for name, layer in model.layers().items():
            layer.weight.copy_(torch.tensor(
                np.asarray(state_dict[prefix + name + ".weight"], np.float32)))
            layer.bias.copy_(torch.tensor(
                np.asarray(state_dict[prefix + name + ".bias"], np.float32)))
            ls = state_dict.get(prefix + name + ".weight_scaling")
            if ls is not None:
                layer.weight_scaling = torch.tensor(
                    np.asarray(ls, np.float32).reshape(-1, 1), device=device)
    return model


def params_to_state_dict(model: NeRF, prefix: str) -> Dict[str, np.ndarray]:
    """Inverse of :func:`params_from_state_dict` (numpy, torch layout;
    scales as (out, 1))."""
    return {prefix + k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def from_jax_params(params, config: NeRFConfig, ls=None,
                    device=None) -> NeRF:
    """Take a ``nnc_tpu`` parameter pytree as numpy, ``{name: {"w": (in, out),
    "b": (out,)}}`` with optional scales ``{name: (out,)}``, to a NeRF."""
    model = NeRF(config, device=device)
    with torch.no_grad():
        for name, layer in model.layers().items():
            layer.weight.copy_(torch.tensor(
                np.asarray(params[name]["w"], np.float32).T))
            layer.bias.copy_(torch.tensor(
                np.asarray(params[name]["b"], np.float32)))
            if ls is not None:
                layer.weight_scaling = torch.tensor(
                    np.asarray(ls[name], np.float32).reshape(-1, 1),
                    device=device)
    return model


# mip-NeRF's flax tree: Dense_0..7 the trunk, Dense_8 the density, Dense_9
# the bottleneck, Dense_10 the view layer, Dense_11 the rgb head
MIP_DENSE = {f"Dense_{i}": f"pts_linears.{i}" for i in range(8)}
MIP_DENSE.update(Dense_8="alpha_linear", Dense_9="feature_linear",
                 Dense_10="views_linears.0", Dense_11="rgb_linear")


def _mip_rows(name: str, w: np.ndarray) -> np.ndarray:
    """A mip-NeRF kernel (in, out)'s rows in the port's input order: the
    IPE's channels (``IPE_FROM_MIP``), the skip layer's [inputs, h] where
    mip-NeRF concatenates [h, inputs], the view layer's encoding
    (``VIEWS_FROM_MIP``)."""
    if name == "pts_linears.0":
        return w[IPE_FROM_MIP]
    if name == "pts_linears.5":
        h = w.shape[0] - IPE_FROM_MIP.size
        return np.concatenate([w[h + IPE_FROM_MIP], w[:h]])
    if name == "views_linears.0":
        f = w.shape[0] - VIEWS_FROM_MIP.size
        return np.concatenate([w[:f], w[f + VIEWS_FROM_MIP]])
    return w


def from_mipnerf_params(tree, scales=None, device=None) -> NeRF:
    """mip-NeRF's MLP from its flax parameter tree (numpy or tensors,
    ``{"Dense_i": {"kernel": (in, out), "bias": (out,)}}``, as
    ``MipNerfModel``'s ``params["params"]["MLP_0"]`` holds it) as the port's
    :data:`MIPNERF` module, the rows permuted into the port's channel and
    skip order; ``scales`` ({"Dense_i": (out,)}), if given, become LSA
    scales."""
    host = lambda a: (a.detach().cpu().numpy() if torch.is_tensor(a)
                      else np.asarray(a)).astype(np.float32)
    model = NeRF(MIPNERF, device=device)
    layers = model.layers()
    with torch.no_grad():
        for dense, name in MIP_DENSE.items():
            kernel = host(tree[dense]["kernel"])
            layers[name].weight.copy_(torch.as_tensor(
                _mip_rows(name, kernel).T.copy()))
            layers[name].bias.copy_(torch.as_tensor(host(tree[dense]["bias"])))
            if scales is not None:
                layers[name].weight_scaling = torch.as_tensor(
                    host(scales[dense]).reshape(-1, 1),
                    device=layers[name].weight.device)
    return model
