"""mip-NeRF 360's two MLPs as PyTorch modules with LSA scales.

mip-NeRF 360 (Barron et al., CVPR 2022; github.com/google-research/multinerf
``internal/models.py`` ``MLP`` with ``configs/360.gin``) renders an
unbounded scene with two networks: the proposal MLP (``PropMLP``: 4 ReLU
layers of 256 and a density head, no colour), which serves both proposal
levels, and the NeRF MLP (``NerfMLP``: 8 ReLU layers of 1,024, the encoding
concatenated after layer 4, a density head, a 256-wide bottleneck, one
128-wide ReLU view layer on [bottleneck, posenc 4 of the view direction]
and the rgb head). Both take the 504 channels of the integrated positional
encoding of a contracted Gaussian (``render/mipnerf360.py``).

The modules keep multinerf's channel order (the encoding's [sines, cosines],
the skip's [h, inputs], the view layer's [bottleneck, encoding]) and name
their layers as the codec's NeRF checkpoints do: ``pts_linears.{i}`` the
trunk, ``alpha_linear`` the density, ``feature_linear`` the bottleneck,
``views_linears.0`` the view layer, ``rgb_linear`` the colour. Each is a
``nerf.Linear`` (weight (out, in), bias, an optional (out, 1)
``weight_scaling``); every layer runs as one GEMM and K-B7's epilogue
(``ops/lsa_epilogue.scaled_linear``). A checkpoint holds the proposal MLP as
``model.*`` and the NeRF MLP as ``model_fine.*``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

from ..ops import lsa_epilogue
from .nerf import Linear


@dataclasses.dataclass(frozen=True)
class MLP360Config:
    """One of the two MLPs: ``depth`` ReLU layers of ``width`` on
    ``input_ch`` encoded channels, the encoding concatenated after every
    layer i with i % ``skip`` == 0 and i > 0; with ``rgb`` the bottleneck
    (``bottleneck`` wide, no activation), the view layer (``view_width``,
    on ``views_ch`` channels of the view direction's encoding) and the rgb
    head."""
    depth: int
    width: int
    input_ch: int = 504
    skip: int = 4
    rgb: bool = False
    bottleneck: int = 256
    view_width: int = 128
    views_ch: int = 27

    def skips_after(self, i: int) -> bool:
        return i % self.skip == 0 and i > 0


# configs/360.gin: NerfMLP.net_depth 8, net_width 1024; PropMLP.net_depth 4,
# net_width 256, disable_rgb; MLP's defaults: bottleneck_width 256,
# net_width_viewdirs 128, skip_layer 4, max_deg_point 12 over 21 basis
# directions (504 channels), deg_view 4 (27)
NERF_MLP = MLP360Config(depth=8, width=1024, rgb=True)
PROP_MLP = MLP360Config(depth=4, width=256)


def layer_dims(config: MLP360Config) -> Dict[str, tuple]:
    """{layer name: (in, out)} in the order multinerf creates the layers
    (trunk, density, bottleneck, view, rgb)."""
    dims, d_in = {}, config.input_ch
    for i in range(config.depth):
        dims[f"pts_linears.{i}"] = (d_in, config.width)
        d_in = config.width + (config.input_ch if config.skips_after(i)
                               else 0)
    dims["alpha_linear"] = (d_in, 1)
    if config.rgb:
        dims["feature_linear"] = (d_in, config.bottleneck)
        dims["views_linears.0"] = (config.bottleneck + config.views_ch,
                                   config.view_width)
        dims["rgb_linear"] = (config.view_width, 3)
    return dims


class MLP360(nn.Module):
    def __init__(self, config: MLP360Config, device=None):
        super().__init__()
        self.config = config
        dims = layer_dims(config)
        self.pts_linears = nn.ModuleList(
            Linear(*dims[f"pts_linears.{i}"], device=device)
            for i in range(config.depth))
        self.alpha_linear = Linear(*dims["alpha_linear"], device=device)
        if config.rgb:
            self.feature_linear = Linear(*dims["feature_linear"],
                                         device=device)
            self.views_linears = nn.ModuleList(
                [Linear(*dims["views_linears.0"], device=device)])
            self.rgb_linear = Linear(*dims["rgb_linear"], device=device)

    def layers(self) -> Dict[str, Linear]:
        """{layer name: Linear} in multinerf's order."""
        return {name: self.get_submodule(name)
                for name in layer_dims(self.config)}

    @property
    def device(self) -> torch.device:
        return self.pts_linears[0].weight.device

    def forward(self, enc, views_enc=None):
        """enc: (P, input_ch) the encoded Gaussians; views_enc: (P, views_ch)
        (with ``rgb``). Returns (raw density (P,), raw rgb (P, 3) or None):
        before the density's bias and softplus and the colour's sigmoid."""
        cfg = self.config
        xs = (enc,)
        for i, layer in enumerate(self.pts_linears):
            h = lsa_epilogue.scaled_linear(layer, xs, relu=True)
            # after a skip the next layer's input is [h, enc]: two
            # products summed into one
            xs = (h, enc) if cfg.skips_after(i) else (h,)
        density = lsa_epilogue.scaled_linear(self.alpha_linear, xs,
                                             relu=False)[:, 0]
        if not cfg.rgb:
            return density, None
        bottleneck = lsa_epilogue.scaled_linear(self.feature_linear, xs,
                                                relu=False)
        h = lsa_epilogue.scaled_linear(self.views_linears[0],
                                       (bottleneck, views_enc), relu=True)
        return density, lsa_epilogue.scaled_linear(self.rgb_linear, (h,),
                                                   relu=False)


# ----------------------------------------------------------- checkpoints
def params_from_state_dict(state_dict: Mapping[str, np.ndarray], prefix: str,
                           config: MLP360Config, device=None) -> MLP360:
    """The MLP from a flat state dict in torch layout (``{prefix}{layer}.
    weight`` (out, in), ``.bias``, optional ``.weight_scaling``)."""
    model = MLP360(config, device=device)
    with torch.no_grad():
        for name, layer in model.layers().items():
            for attr in ("weight", "bias"):
                getattr(layer, attr).copy_(torch.as_tensor(np.asarray(
                    state_dict[prefix + name + "." + attr], np.float32)))
            ls = state_dict.get(prefix + name + ".weight_scaling")
            if ls is not None:
                layer.weight_scaling = torch.as_tensor(
                    np.asarray(ls, np.float32).reshape(-1, 1), device=device)
    return model


def _dense_names(config: MLP360Config) -> Dict[str, str]:
    """{flax Dense_i: the port's layer}: multinerf creates the trunk's
    layers, then the density, then (with rgb) the bottleneck, the view layer
    and the rgb head, each ``nn.Dense`` named in creation order."""
    return {f"Dense_{i}": name
            for i, name in enumerate(layer_dims(config))}


def from_mipnerf360_params(tree, device=None,
                           prop: MLP360Config = PROP_MLP,
                           nerf: MLP360Config = NERF_MLP):
    """(proposal MLP, NeRF MLP) from multinerf's flax parameter tree
    (numpy or tensors): ``tree["prop_mlp"]`` and ``tree["nerf_mlp"]``, each
    ``{"Dense_i": {"kernel": (in, out), "bias": (out,)}}``. The channel
    order is multinerf's own, so only the names change and the kernels are
    transposed."""
    host = lambda a: (a.detach().cpu().numpy() if torch.is_tensor(a)
                      else np.asarray(a)).astype(np.float32)
    out = []
    for key, config in (("prop_mlp", prop), ("nerf_mlp", nerf)):
        model = MLP360(config, device=device)
        layers = model.layers()
        with torch.no_grad():
            for dense, name in _dense_names(config).items():
                layer = layers[name]
                layer.weight.copy_(torch.as_tensor(
                    host(tree[key][dense]["kernel"]).T.copy()))
                layer.bias.copy_(torch.as_tensor(
                    host(tree[key][dense]["bias"])))
        out.append(model)
    return tuple(out)
