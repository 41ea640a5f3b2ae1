"""PyTorch-ecosystem adapter: state dicts <-> codec parameter dicts.

torch is used only for (de)serializing ``.pt``/``.tar`` checkpoint files and
converting tensors to numpy; all compute stays in JAX. Type inference and
block grouping follow the reference adapter
(reference: framework/pytorch_model/__init__.py:260-610).
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from ..core.model import NNRModel
from .. import hls

_INT_DTYPES = ("int8", "int16", "int32", "uint8", "uint16", "uint32")
_1BYTE = ("int8", "uint8")
_2BYTE = ("int16", "uint16", "float16")


def _torch():
    import torch
    return torch


def is_torch_model(obj) -> bool:
    try:
        torch = _torch()
    except ImportError:  # pragma: no cover
        return False
    return isinstance(obj, (torch.nn.Module, dict, OrderedDict)) and (
        not isinstance(obj, dict) or all(
            hasattr(v, "detach") or isinstance(v, np.ndarray)
            for v in obj.values()))


def state_dict_to_numpy(state_dict) -> "OrderedDict[str, np.ndarray]":
    """torch state dict -> numpy dict, stripping DataParallel 'module.'
    prefixes. (reference: pytorch_model/__init__.py:271-322)"""
    out = OrderedDict()
    for k, v in state_dict.items():
        name = k[len("module."):] if k.startswith("module.") else k
        arr = v.detach().cpu().numpy() if hasattr(v, "detach") \
            else np.asarray(v)
        out[name] = arr
    return out


def infer_param_type(name: str, ndim: int) -> str:
    """Name+dims based parameter typing.
    (reference: pytorch_model/__init__.py:449-472)"""
    end = name.split(".")[-1]
    if ndim > 1:
        return "weight"
    if ndim == 1:
        if "bias" in end or "beta" in end:
            return "bias"
        if "running_mean" in end or "moving_mean" in end:
            return "bn.mean"
        if "running_var" in end or "moving_variance" in end:
            return "bn.var"
        if "weight_scaling" in end:
            return "weight.ls"
        if "gamma" in end:
            return "bn.gamma"
        if "weight" in end:
            return "weight"
    return "unspecified"


class TorchModel(NNRModel):
    """NNRModel over a torch state dict (or nn.Module)."""

    def __init__(self, model=None):
        super().__init__()
        self.model = None
        self._model_info_t = None
        if model is not None:
            self.init_model_from_model_object(model)

    def init_model_from_model_object(self, model):
        torch = _torch()
        if isinstance(model, torch.nn.Module):
            self.model = model
            sd = model.state_dict()
        else:
            sd = model
        return self.init_model_from_dict(state_dict_to_numpy(sd))

    def init_model_from_dict(self, model_dict):
        """numpy dict -> parameters + model_info with torch naming rules:
        weight_scaling tensors are flattened; types inferred by name.
        (reference: pytorch_model/__init__.py:336-482)"""
        parameters = {}
        model_info = {
            "parameter_type": {},
            "parameter_dimensions": {},
            "parameter_index": {},
            "block_identifier": {},
            "topology_storage_format": hls.TopologyStorageFormat.NNR_TPL_PYT,
            "topology_compression_format":
                hls.TopologyCompressionFormat.NNR_PT_RAW,
        }
        original_size = 0
        for i, name in enumerate(model_dict):
            arr = np.asarray(model_dict[name])
            dtype = arr.dtype.name
            nbytes = 1 if dtype in _1BYTE else 2 if dtype in _2BYTE else 4
            original_size += arr.size * nbytes
            if dtype in _INT_DTYPES:
                arr = arr.astype(np.int32)
            else:
                arr = arr.astype(np.float32)
            if ".weight_scaling" in name:
                arr = arr.flatten()
            if arr.ndim == 0:
                arr = arr.reshape(1).astype(np.float32)
            parameters[name] = arr
            model_info["parameter_dimensions"][name] = arr.shape
            model_info["parameter_index"][name] = i
            model_info["parameter_type"][name] = infer_param_type(
                name, arr.ndim)
        model_info["original_size"] = original_size
        self._model_info_t = model_info
        return parameters

    @property
    def model_info(self):
        return self._model_info_t

    def guess_block_id_and_param_type(self, model_parameters):
        """Group params into per-module blocks; merge BN blocks into the
        matching weight block by channel count.
        (reference: pytorch_model/__init__.py:496-610)"""
        try:
            out = {"block_identifier": {}, "parameter_type": {}}
            block_dict = OrderedDict()
            blk_num = -1
            for param, value in model_parameters.items():
                dims = len(value.shape)
                pshape = value.shape
                parts = param.split(".")
                base = ".".join(parts[:-1] + [""]) if parts[:-1] \
                    else "genericBlk."
                ptype = infer_param_type(param, dims)
                block_eligible = ptype != "unspecified"
                if not block_eligible:
                    out["parameter_type"][param] = ptype
                    out["block_identifier"][param] = None
                    continue
                block_id = base + str(blk_num)
                if block_id in block_dict:
                    if any(a[1] == ptype for a in block_dict[block_id]):
                        blk_num += 1
                    block_id = base + str(blk_num)
                else:
                    blk_num += 1
                    block_id = base + str(blk_num)
                block_dict.setdefault(block_id, []).append(
                    [param, ptype, block_id, dims, pshape])

            weight_blocks, bn_blocks = [], []
            for block_list in block_dict.values():
                if any("bn." in a[1] for a in block_list):
                    for entry in block_list:
                        if entry[1] == "weight" and entry[3] == 1:
                            entry[1] = "bn.gamma"
                        if entry[1] == "bias":
                            entry[1] = "bn.beta"
                    bn_blocks.append(block_list)
                else:
                    weight_blocks.append(block_list)

            for weight_block in weight_blocks:
                weight_shape, weight_bid = None, None
                for par, ptype, bid, _dims, pshape in weight_block:
                    out["parameter_type"][par] = ptype
                    out["block_identifier"][par] = bid
                    if ptype == "weight":
                        weight_shape = pshape
                        weight_bid = bid
                if bn_blocks and weight_shape is not None and any(
                        dim == bn_blocks[0][0][4][0] for dim in weight_shape):
                    bn_block = bn_blocks.pop(0)
                    for par, ptype, *_ in bn_block:
                        out["parameter_type"][par] = ptype
                        out["block_identifier"][par] = weight_bid
            assert not bn_blocks
            return out
        except Exception:
            print("INFO: Guessing of block_id_and_parameter_type failed! "
                  "block_id_and_parameter_type has been set to 'None'!")
            return None


def create_NNC_model_instance_from_object(model_object):
    nnc_mdl = TorchModel(model_object)
    params = nnc_mdl.init_model_from_model_object(model_object)
    return nnc_mdl, params


def create_NNC_model_instance_from_file(model_path):
    torch = _torch()
    loaded = torch.load(model_path, map_location="cpu", weights_only=True)
    if isinstance(loaded, dict) and "state_dict" in loaded:
        loaded = loaded["state_dict"]
    if isinstance(loaded, dict) and "network_fn_state_dict" in loaded:
        # nerf-pytorch .tar checkpoint: flatten to the wrapper layout
        # (reference flow: compress_nerf.py wraps first; accepting the .tar
        # directly makes compress_model('ckpt.tar') just work)
        from ..utils.ckpt import nerf_tar_to_wrapper_dict
        loaded, _step = nerf_tar_to_wrapper_dict(model_path)
    nnc_mdl = TorchModel()
    params = nnc_mdl.init_model_from_dict(
        state_dict_to_numpy(loaded))
    return nnc_mdl, params


def save_to_torch_file(parameters, path):
    """Save a numpy parameter dict as a torch ``.pt`` state dict.
    (reference: pytorch_model/__init__.py:239-243)"""
    torch = _torch()
    sd = OrderedDict((k, torch.from_numpy(np.ascontiguousarray(v)))
                     for k, v in parameters.items())
    torch.save(sd, path)
