"""Checkpoint format round trips: nerf-pytorch ``.tar`` <-> NeRFWrapper
``.pt`` <-> flat numpy dicts, plus the timestamped output-folder layout.

(reference: utils.py:109-239.)
"""
from __future__ import annotations

import os
from collections import OrderedDict
from datetime import datetime, timedelta

import numpy as np


def _torch():
    import torch
    return torch


def load_nerf_tar(ckpt_path):
    """Load a nerf-pytorch ``.tar`` checkpoint into numpy state dicts.

    Returns dict with keys: network_fn (dict), network_fine (dict, empty
    for a one-network model such as mip-NeRF's), global_step (int)."""
    torch = _torch()
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    to_np = lambda sd: OrderedDict(
        (k, v.detach().cpu().numpy() if hasattr(v, "detach")
         else np.asarray(v)) for k, v in sd.items())
    return {
        "network_fn": to_np(ckpt["network_fn_state_dict"]),
        "network_fine": to_np(ckpt.get("network_fine_state_dict", {})),
        "global_step": int(ckpt.get("global_step", 0)),
    }


def nerf_tar_to_wrapper_dict(ckpt_path):
    """``.tar`` -> flat wrapper dict {'model.*', 'model_fine.*'}.
    (reference: utils.py:109-130 builds the NeRFWrapper module; we build the
    equivalent flat numpy state dict.)"""
    c = load_nerf_tar(ckpt_path)
    out = OrderedDict()
    for k, v in c["network_fn"].items():
        out["model." + k] = v
    for k, v in c["network_fine"].items():
        out["model_fine." + k] = v
    return out, c["global_step"]


def wrapper_dict_to_nerf_tar(wrapper_dict, ckpt_path, global_step=200000):
    """Flat wrapper dict (numpy or torch tensors) -> nerf-pytorch ``.tar``.
    (reference: utils.py:133-157)"""
    torch = _torch()
    t = lambda v: v if torch.is_tensor(v) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(v)))
    model_sd = OrderedDict((k[len("model."):], t(v))
                           for k, v in wrapper_dict.items()
                           if k.startswith("model.")
                           and not k.startswith("model_fine."))
    fine_sd = OrderedDict((k[len("model_fine."):], t(v))
                          for k, v in wrapper_dict.items()
                          if k.startswith("model_fine."))
    grad_vars = [p for p in list(model_sd.values()) + list(fine_sd.values())
                 if p.dtype.is_floating_point]
    optimizer = torch.optim.Adam(params=grad_vars, lr=1e-4,
                                 betas=(0.9, 0.999))
    torch.save({
        "network_fn_state_dict": model_sd,
        "network_fine_state_dict": fine_sd,
        "global_step": global_step,
        "optimizer_state_dict": optimizer.state_dict(),
    }, ckpt_path)


def convert_nerfwrapper_to_nerf_ckpt(nerfwrapper_path, ckpt_path):
    """``.pt`` (flat wrapper state dict) -> ``.tar``."""
    torch = _torch()
    loaded = torch.load(nerfwrapper_path, map_location="cpu", weights_only=True)
    wrapper_dict_to_nerf_tar(loaded, ckpt_path)
    print(f"Saved the checkpoint in standard nerf_ckpt format to {ckpt_path}")


def change_extension_to_tar(model_path: str) -> str:
    root, _ = os.path.splitext(model_path)
    return root + ".tar"


def convert_tar_to_pt(tar_file_path, pt_file_path):
    torch = _torch()
    ckpt = torch.load(tar_file_path, map_location="cpu", weights_only=True)
    torch.save({
        "global_step": ckpt["global_step"],
        "network_fn_state_dict": ckpt["network_fn_state_dict"],
        "network_fine_state_dict": ckpt["network_fine_state_dict"],
        "optimizer_state_dict": ckpt["optimizer_state_dict"],
    }, pt_file_path)


def create_save_path(base_path_to_save, ckpt_nickname, qp, lsa, epochs,
                     learning_rate, task_type, dataset_type, N_iters,
                     learning_rate_decay):
    """Timestamped run-folder layout with bitstream/ and reconstructed/.
    (reference: utils.py:207-239, including the timestamp-minus-9h quirk.)"""
    now = datetime.now() - timedelta(hours=9)
    current_time = now.strftime("%y%m%d%H%M%S")
    filename = os.path.splitext(os.path.basename(ckpt_nickname))[0]
    if lsa:
        info_str = (f"{current_time}_{filename}_qp{qp}_e{epochs}_"
                    f"lr{str(learning_rate).replace('.', 'p')}_"
                    f"decay{learning_rate_decay}_N{N_iters}_{dataset_type}")
    else:
        info_str = f"{current_time}_lsaFalse_{filename}_qp{qp}_{dataset_type}"

    bitstream_dir = os.path.join(base_path_to_save, info_str, "bitstream")
    reconstructed_dir = os.path.join(base_path_to_save, info_str,
                                     "reconstructed")
    os.makedirs(bitstream_dir, exist_ok=True)
    os.makedirs(reconstructed_dir, exist_ok=True)
    return {
        "bitstream": os.path.join(bitstream_dir, f"{info_str}_bitstream.nnc"),
        "reconstructed": os.path.join(reconstructed_dir,
                                      f"{info_str}_reconstructed.pt"),
    }
