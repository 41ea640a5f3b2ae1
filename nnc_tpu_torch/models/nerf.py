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

The working dtype is float32 throughout.
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

    def forward(self, x):
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

    def forward(self, pts_emb, views_emb=None):
        """pts_emb: (..., input_ch); views_emb: (..., input_ch_views).
        Returns raw (..., 4) = (rgb logits, sigma)."""
        cfg = self.config
        h = pts_emb
        for i, layer in enumerate(self.pts_linears):
            h = F.relu(layer(h))
            if i in cfg.skips:
                h = torch.cat([pts_emb, h], dim=-1)
        if cfg.use_viewdirs:
            alpha = self.alpha_linear(h)
            feature = self.feature_linear(h)
            h = torch.cat([feature, views_emb], dim=-1)
            h = F.relu(self.views_linears[0](h))
            rgb = self.rgb_linear(h)
            return torch.cat([rgb, alpha], dim=-1)
        return self.output_linear(h)


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


def apply_mlp(model: NeRF, pts_emb, views_emb=None):
    """Forward the MLP on embedded points (+ embedded view dirs)."""
    return model(pts_emb, views_emb)


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
    """Infer D/W/skips/viewdirs from a flat torch-layout state dict."""
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
