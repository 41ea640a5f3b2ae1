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
    return out
