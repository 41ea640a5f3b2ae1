"""nerf-pytorch style config-file parser (configs/*.txt).

The reference ships per-scene config files in this format but its LSA
pipeline hardcodes their contents (reference: framework/nerf_model/configs/,
noted unused at SURVEY §2.1). Here they are first-class: `load_config` parses
``key = value`` lines and `scene_overrides` maps them onto the scene/preset
knobs so custom scenes don't require code edits.
"""
from __future__ import annotations

import os


def _parse_value(raw: str):
    raw = raw.strip()
    if raw.lower() in ("true", "false"):
        return raw.lower() == "true"
    for cast in (int, float):
        try:
            return cast(raw)
        except ValueError:
            continue
    return raw


def load_config(path: str) -> dict:
    cfg = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, val = line.split("=", 1)
            cfg[key.strip()] = _parse_value(val)
    return cfg


def scene_overrides(cfg: dict) -> dict:
    """Extract the knobs load_scene/make_render_config understand."""
    out = {}
    mapping = {
        "dataset_type": "dataset_type",
        "datadir": "data_dir",
        "half_res": "half_res",
        "testskip": "testskip",
        "factor": "factor",
        "llffhold": "llffhold",
        "spherify": "spherify",
        "white_bkgd": "white_bkgd",
        "N_samples": "n_samples",
        "N_importance": "n_importance",
        "N_rand": "n_rand",
        "raw_noise_std": "raw_noise_std",
        "lindisp": "lindisp",
        "no_ndc": "no_ndc",
    }
    for src, dst in mapping.items():
        if src in cfg:
            out[dst] = cfg[src]
    if cfg.get("model") == "mipnerf":
        out["model"] = "mipnerf"
        out["near"], out["far"] = float(cfg.get("near", 2.0)), \
            float(cfg.get("far", 6.0))
        out["mip"] = {k: cfg[k] for k in MIP_KEYS if k in cfg}
    if cfg.get("model") == "mipnerf360":
        out["model"] = "mipnerf360"
        out["near"], out["far"] = float(cfg.get("near", 0.2)), \
            float(cfg.get("far", 1e6))
        out["mip360"] = {k: cfg[k] for k in MIP360_KEYS if k in cfg}
    return out


# a mip-NeRF config's keys (configs/blender.gin's names), which
# render/mipnerf.MipRenderConfig takes
MIP_KEYS = ("num_samples", "num_levels", "resample_padding", "min_deg_point",
            "max_deg_point", "deg_view", "density_bias", "rgb_padding",
            "coarse_loss_mult")
# a mip-NeRF 360 config's keys (multinerf's configs/360.gin and Model /
# Config names), which render/mipnerf360.make_render_config checks
MIP360_KEYS = ("num_levels", "num_prop_samples", "num_nerf_samples",
               "dilation_bias", "dilation_multiplier", "resample_padding",
               "min_deg_point", "max_deg_point", "deg_view", "density_bias",
               "rgb_padding", "charb_padding", "interlevel_loss_mult",
               "distortion_loss_mult", "basis_subdivisions")
