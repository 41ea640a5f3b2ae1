"""NNR model abstraction: parameter dicts, model_info, block access.

The codec operates on a flat ``{name: np.ndarray}`` parameter dict plus a
``model_info`` dict describing each tensor (type, dims, index, block id,
topology format). Blocks group a layer's weight with its bias / LSA scale /
batch-norm tensors into a single NNR data unit.

Semantics match the reference model layer (reference:
nnc_core/nnr_model/__init__.py:10-682) with naming conventions:
``<w>_scaling`` = LSA scale (type ``weight.ls``), ``<w>_G``/``<w>_H`` =
low-rank decomposition factors.
"""
from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np

from .. import hls
from ..hls import TopologyStorageFormat, TopologyCompressionFormat

W_TYPES = ["weight"]
O_TYPES = ["weight.ls", "bias", "bn.beta", "bn.gamma", "bn.mean", "bn.var",
           "unspecified"]

_INT_DTYPES = ("int8", "int16", "int32", "uint8", "uint16", "uint32")
_1BYTE = ("int8", "uint8")
_2BYTE = ("int16", "uint16", "float16")


class ModelExecute(ABC):
    """Capability interface the codec calls back into for data-driven stages
    (LSA / fine-tuning / IOQ). (reference: nnc_core/nnr_model/__init__.py:42-98)
    """

    def eval_model(self, parameters, verbose=False):
        raise NotImplementedError(
            "eval_model not implemented (required for IOQ; set ioq=False).")

    def test_model(self, parameters, verbose=False):
        raise NotImplementedError("test_model not implemented.")

    def tune_model(self, parameters, param_types, lsa_flag, ft_flag,
                   verbose=False):
        raise NotImplementedError(
            "tune_model not implemented (required for lsa/fine_tune).")

    @abstractmethod
    def has_eval(self) -> bool:
        ...

    @abstractmethod
    def has_test(self) -> bool:
        ...

    @abstractmethod
    def has_tune_ft(self) -> bool:
        ...

    @abstractmethod
    def has_tune_lsa(self) -> bool:
        ...


class NNRModel:
    """Generic model: builds model_info from a flat state dict of arrays.

    (reference: nnc_core/nnr_model/__init__.py:156-309)
    """

    def __init__(self, model_dict=None):
        self._model_info = None
        self.model = None
        if model_dict is not None and isinstance(model_dict, dict):
            self.init_model_from_dict(model_dict)

    def init_model_from_dict(self, model_dict):
        if not isinstance(model_dict, dict):
            raise SystemExit("model_dict must be of type dict")

        parameters = {}
        model_info = {
            "parameter_type": {},
            "parameter_dimensions": {},
            "parameter_index": {},
            "block_identifier": {},
            "original_size": {},
            "topology_storage_format": None,
            "topology_compression_format": None,
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
            if arr.ndim == 0:  # scalar -> 1-element vector
                arr = arr.reshape(1).astype(np.float32)
            parameters[name] = arr
            model_info["parameter_dimensions"][name] = arr.shape
            model_info["parameter_index"][name] = i
            model_info["parameter_type"][name] = (
                "weight" if arr.ndim > 1 else "unspecified")

        model_info["topology_storage_format"] = TopologyStorageFormat.NNR_TPL_UNREC
        model_info["topology_compression_format"] = TopologyCompressionFormat.NNR_PT_RAW
        model_info["original_size"] = original_size
        self._model_info = model_info
        return parameters

    def guess_block_id_and_param_type(self, model_parameters):
        raise SystemExit(
            "Block id and parameter type cannot be guessed for the generic "
            "model class. Provide a framework model or "
            "block_id_and_param_type.")

    @property
    def model_info(self):
        return self._model_info


class NNRParamAccess:
    """Access to a free-standing (non-block) parameter.
    (reference: nnc_core/nnr_model/__init__.py:312-359)"""

    def __init__(self, model_info, param):
        self._single = (model_info["parameter_type"].get(param), param,
                        model_info["parameter_dimensions"].get(param))

    def param_generator(self, _cpt_dict):
        yield self._single

    @property
    def block_id(self):
        return None

    @property
    def param(self):
        return self._single[1]


class NNRBlockAccess:
    """Access to a block (weight + companion tensors).
    (reference: nnc_core/nnr_model/__init__.py:362-505)"""

    def __init__(self, model_info, block_identifier):
        self._bid = block_identifier
        self._mi = model_info
        block_list = [x for x in model_info["block_identifier"]
                      if model_info["block_identifier"][x] == block_identifier]
        self._block_dict = {model_info["parameter_type"][x]: x
                            for x in block_list}

    @property
    def block_id(self):
        return self._bid

    @property
    def w(self):
        return self._block_dict.get("weight")

    @property
    def dc_g(self):
        return self.w + "_G"

    @property
    def dc_h(self):
        return self.w + "_H"

    @property
    def ls(self):
        return self.w + "_scaling"

    @property
    def bn_beta(self):
        return self._block_dict.get("bn.beta")

    @property
    def bn_gamma(self):
        return self._block_dict.get("bn.gamma")

    @property
    def bn_mean(self):
        return self._block_dict.get("bn.mean")

    @property
    def bn_var(self):
        return self._block_dict.get("bn.var")

    @property
    def bi(self):
        if "bias" in self._block_dict:
            return self._block_dict["bias"]
        if "weight" in self._block_dict:
            return self._block_dict["weight"] + ".bias"
        return None

    def param_generator(self, cpt_dict):
        """Yield (type, name, dims) for each coded tensor of the block, in
        NNR payload order: ls, bias, bn.*, then weight (or its G/H factors)."""
        cpt = cpt_dict[self.block_id]
        dims_w = self._mi["parameter_dimensions"][self.w]
        if cpt & hls.BlockParameterTypes.NNR_CPT_LS:
            yield "weight.ls", self.ls, [dims_w[0]]
        if cpt & hls.BlockParameterTypes.NNR_CPT_BI:
            yield "bias", self.bi, [dims_w[0]]
        if cpt & hls.BlockParameterTypes.NNR_CPT_BN:
            for t, n in (("bn.beta", self.bn_beta), ("bn.gamma", self.bn_gamma),
                         ("bn.mean", self.bn_mean), ("bn.var", self.bn_var)):
                yield t, n, self._mi["parameter_dimensions"][n]
        if cpt & hls.BlockParameterTypes.NNR_CPT_DC:
            yield "weight", self.dc_g, dims_w
            yield "weight", self.dc_h, dims_w
        else:
            yield "weight", self.w, dims_w

    def topology_elem_generator(self, cpt_dict):
        cpt = cpt_dict[self.block_id]
        if cpt & hls.BlockParameterTypes.NNR_CPT_DC:
            yield self.dc_g
            yield self.dc_h
        else:
            yield self.w
        if cpt & hls.BlockParameterTypes.NNR_CPT_LS:
            yield self.ls
        if cpt & hls.BlockParameterTypes.NNR_CPT_BN:
            yield self.bn_beta
            yield self.bn_gamma
            yield self.bn_mean
            yield self.bn_var
        if cpt & hls.BlockParameterTypes.NNR_CPT_BI:
            yield self.bi


class NNRModelAccess:
    """Iterate blocks and free parameters in parameter-index order.
    (reference: nnc_core/nnr_model/__init__.py:508-548)"""

    def __init__(self, model_info):
        self._mi = model_info
        self._block_list = []
        block_set_check = set(model_info["block_identifier"].values())
        params_sorted = sorted(model_info["parameter_index"],
                               key=model_info["parameter_index"].get)
        for param in params_sorted:
            if param in model_info["block_identifier"]:
                if model_info["parameter_type"][param] in W_TYPES:
                    bid = model_info["block_identifier"][param]
                    self._block_list.append((bid, param))
                    block_set_check.discard(bid)
            else:
                self._block_list.append((None, param))
        assert not block_set_check, (
            f"Unresolved block identifiers: {block_set_check}")

    def blocks_and_params(self):
        for block_id, param in self._block_list:
            if block_id is None:
                yield NNRParamAccess(self._mi, param)
            else:
                yield NNRBlockAccess(self._mi, block_id)


def set_block_id_and_param_type(model_info, block_id_and_param_type):
    """Apply a user/framework-provided block structure onto model_info.
    (reference: nnc_core/nnr_model/__init__.py:552-587)"""
    assert "block_identifier" in block_id_and_param_type
    assert "parameter_type" in block_id_and_param_type
    model_info["block_identifier"] = {}
    bid_values = list(block_id_and_param_type["block_identifier"].values())
    for param in model_info["parameter_index"]:
        ptype = block_id_and_param_type["parameter_type"].get(param)
        if ptype is not None:
            model_info["parameter_type"][param] = ptype
        bid = block_id_and_param_type["block_identifier"].get(param)
        # a block must group >1 tensors; singletons stay block-less
        if bid is not None and bid_values.count(bid) > 1:
            model_info["block_identifier"][param] = bid


def add_lsa_to_block_id_and_param_type(block_id_and_param_type, lsa_params):
    """Register freshly created LSA scales (``<w>_scaling``) in the block map.
    (reference: nnc_core/nnr_model/__init__.py:590-608)"""
    suffix = "_scaling"
    for key in lsa_params:
        if key not in block_id_and_param_type["block_identifier"]:
            base = key[:-len(suffix)] if key.endswith(suffix) else key
            block_id_and_param_type["block_identifier"][key] = (
                block_id_and_param_type["block_identifier"].get(base))
            block_id_and_param_type["parameter_type"][key] = "weight.ls"


def sanity_check_block_id_and_param_type(block_id_and_param_type,
                                         model_parameters=None):
    """Validate block structure: exactly one weight per block, legal types,
    consistent leading dims, 1-D companions.
    (reference: nnc_core/nnr_model/__init__.py:611-682)"""
    block_dict = {}
    for param, bid in block_id_and_param_type["block_identifier"].items():
        if bid is None:
            continue
        ptype = block_id_and_param_type["parameter_type"][param]
        pshape = model_parameters[param].shape if model_parameters else None
        if model_parameters and ptype != "weight" and len(pshape) != 1:
            return False
        block_dict.setdefault(bid, []).append((param, ptype, pshape))

    for _bid, blist in block_dict.items():
        available = ["weight", "weight.ls", "bias", "bn.mean", "bn.var",
                     "bn.gamma", "bn.beta"]
        last_shape = None
        for _par, ptype, pshape in blist:
            if ptype not in available and ptype != "unspecified":
                return False
            if ptype != "unspecified":
                available.remove(ptype)
            if last_shape is not None and pshape is not None and \
                    last_shape[0] != pshape[0]:
                return False
            if pshape is not None:
                last_shape = pshape
        if "weight" in available:
            return False
    return True
