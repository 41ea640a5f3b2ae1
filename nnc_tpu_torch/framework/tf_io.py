"""TensorFlow/Keras-ecosystem adapter: h5 weight files <-> codec dicts.

Only file-level interop is needed (the compute path is JAX): h5 weight files
are read/written with h5py, parameter types inferred from Keras naming
(kernel/beta/gamma/moving_mean/moving_variance). As in the reference, TF
models can be compressed/decompressed but not LSA-tuned
(reference: framework/tensorflow_model/__init__.py:14-578; lsa force-off at
nnc/compression.py:136-138).
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from .. import hls
from ..core.model import NNRModel


def is_tef_model(obj) -> bool:
    """True for h5 paths or objects exposing a Keras-style get_weights."""
    if isinstance(obj, str):
        return obj.endswith((".h5", ".hdf5"))
    return hasattr(obj, "get_weights") and hasattr(obj, "weights")


def load_h5_weights(path) -> "OrderedDict[str, np.ndarray]":
    import h5py
    out = OrderedDict()

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out[name] = np.asarray(obj)

    with h5py.File(path, "r") as f:
        root = f["model_weights"] if "model_weights" in f else f
        root.visititems(visit)
    return out


def save_to_tensorflow_file(parameters, path):
    """Write a flat parameter dict into an h5 file, one dataset per tensor
    under its full name. (reference: tensorflow_model/__init__.py:18-43)"""
    import h5py
    with h5py.File(path, "w") as f:
        for name, value in parameters.items():
            f.create_dataset(name, data=np.asarray(value))


def infer_tef_param_type(name: str, ndim: int) -> str:
    base = name.split("/")[-1].split(":")[0]
    if ndim > 1 and "kernel" in base:
        return "weight"
    if ndim > 1:
        return "weight"
    if ndim == 1:
        if "bias" in base or "beta" in base:
            return "bias"
        if "moving_mean" in base:
            return "bn.mean"
        if "moving_variance" in base:
            return "bn.var"
        if "gamma" in base:
            return "bn.gamma"
    return "unspecified"


class TensorFlowModel(NNRModel):
    """NNRModel over Keras h5 weights / model objects."""

    def __init__(self, model=None):
        super().__init__()
        self._mi = None
        if model is not None:
            self.init_model_from_model_object(model)

    def init_model_from_model_object(self, model):
        if isinstance(model, str):
            weights = load_h5_weights(model)
        else:
            weights = OrderedDict(
                (w.name, np.asarray(v))
                for w, v in zip(model.weights, model.get_weights()))
        return self.init_model_from_dict(weights)

    def init_model_from_dict(self, model_dict):
        parameters = {}
        model_info = {
            "parameter_type": {},
            "parameter_dimensions": {},
            "parameter_index": {},
            "block_identifier": {},
            "topology_storage_format": hls.TopologyStorageFormat.NNR_TPL_TEF,
            "topology_compression_format":
                hls.TopologyCompressionFormat.NNR_PT_RAW,
        }
        original_size = 0
        for i, name in enumerate(model_dict):
            arr = np.asarray(model_dict[name])
            original_size += arr.nbytes
            arr = arr.astype(np.int32) if arr.dtype.kind in "iu" \
                else arr.astype(np.float32)
            if arr.ndim == 0:
                arr = arr.reshape(1).astype(np.float32)
            parameters[name] = arr
            model_info["parameter_dimensions"][name] = arr.shape
            model_info["parameter_index"][name] = i
            model_info["parameter_type"][name] = infer_tef_param_type(
                name, arr.ndim)
        model_info["original_size"] = original_size
        self._mi = model_info
        return parameters

    @property
    def model_info(self):
        return self._mi

    def guess_block_id_and_param_type(self, model_parameters):
        """Group per layer path (everything before the final '/') with BN
        merging by channel count, mirroring the torch adapter's logic."""
        from .torch_io import TorchModel
        remapped = OrderedDict()
        alias = {}
        for name in model_parameters:
            py_name = name.replace("/", ".").replace(":0", "")
            py_name = (py_name
                       .replace("kernel", "weight")
                       .replace("moving_mean", "running_mean")
                       .replace("moving_variance", "running_var"))
            alias[py_name] = name
            remapped[py_name] = model_parameters[name]
        guessed = TorchModel().guess_block_id_and_param_type(remapped)
        if guessed is None:
            return None
        return {
            "block_identifier": {alias[k]: v for k, v in
                                 guessed["block_identifier"].items()},
            "parameter_type": {alias[k]: v for k, v in
                               guessed["parameter_type"].items()},
        }


def create_NNC_model_instance_from_file(path):
    mdl = TensorFlowModel()
    params = mdl.init_model_from_dict(load_h5_weights(path))
    return mdl, params


def create_NNC_model_instance_from_object(model):
    mdl = TensorFlowModel()
    params = mdl.init_model_from_model_object(model)
    return mdl, params


class KerasModelExecuter:
    """eval/test for Keras models (h5 path or model object).

    Counterpart of the reference's ImageNetTensorFlowModelExecuter
    (reference: framework/tensorflow_model/__init__.py:463-578): TF models
    can be evaluated and tested but not LSA-tuned (has_tune_* return False,
    matching :574-578; lsa is force-disabled for TF models at the codec
    level like the reference's nnc/compression.py:136-138)."""

    def __init__(self, model_or_path, val_loader_fn, test_loader_fn=None, *,
                 max_batches=600, verbose=True):
        import tensorflow as tf  # noqa: F401 (availability check)
        if isinstance(model_or_path, str):
            from tensorflow import keras
            self.model = keras.models.load_model(model_or_path)
        else:
            self.model = model_or_path
        self.val_loader_fn = val_loader_fn
        self.test_loader_fn = test_loader_fn or val_loader_fn
        self.max_batches = max_batches
        self.verbose = verbose

    def _load(self, parameters):
        for w in self.model.weights:
            name = w.name
            if name in parameters:
                w.assign(np.asarray(parameters[name],
                                    np.float32).reshape(w.shape))

    def _evaluate(self, loader):
        import tensorflow as tf
        top1 = top5 = loss_sum = n = 0
        ce = tf.keras.losses.SparseCategoricalCrossentropy(
            from_logits=True, reduction="sum")
        for i, (x, y) in enumerate(loader):
            if i >= self.max_batches:
                break
            logits = self.model(np.asarray(x, np.float32), training=False)
            logits = np.asarray(logits)
            y = np.asarray(y)
            k5 = min(5, logits.shape[-1])
            topk = np.argsort(logits, axis=-1)[:, -k5:]
            top1 += int((topk[:, -1] == y).sum())
            top5 += int((topk == y[:, None]).any(1).sum())
            loss_sum += float(ce(y, logits))
            n += len(y)
        n = max(1, n)
        return top1 / n, top5 / n, loss_sum / n

    def eval_model(self, parameters, verbose=False):
        self._load(parameters)
        return self._evaluate(self.val_loader_fn())

    def test_model(self, parameters, verbose=False):
        self._load(parameters)
        return self._evaluate(self.test_loader_fn())

    def has_eval(self):
        return True

    def has_test(self):
        return True

    def has_tune_ft(self):
        return False

    def has_tune_lsa(self):
        return False
