"""Classification task support: metrics, train/eval loops, and a generic
LSA-capable executer for classifier models expressed as apply functions on
tensors.

Counterpart of ``nnc_tpu/train/classification.py`` (reference:
framework/applications/utils/train.py:15-83, evaluation.py:13-101,
metrics.py:5-20; executer: framework/pytorch_model/__init__.py:613-919). The
model is a user-supplied function ``apply_fn(params, ls, x) -> logits`` over
two nested dicts of tensors (parameters and LSA scales) on one device; LSA
optimizes only the scale dict, with per-epoch best-loss checkpointing and
early stopping like the reference. Each batch goes to the device of the
parameters. Adam is ``train/lsa.Adam``, optax's update as tensor ops.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ..core.model import ModelExecute
from ..utils.device import resolve_device
from .lsa import Adam


def get_topk_accuracy(logits, labels, k=1):
    """Fraction of rows whose label is within the top-k logits.
    (reference: metrics.py:5-20) Ties take the classes that a stable
    ascending sort puts last, as ``jnp.argsort`` does."""
    topk = torch.argsort(logits, dim=-1, stable=True)[:, -k:]
    return (topk == labels[:, None]).any(dim=-1).float().mean()


def cross_entropy(logits, labels):
    rows = torch.arange(labels.shape[0], device=labels.device)
    return (-torch.log_softmax(logits, dim=-1)[rows, labels]).mean()


def _leaves(tree):
    """The tensors of a nested dict, in key order."""
    if isinstance(tree, dict):
        return [t for k in tree for t in _leaves(tree[k])]
    return [tree]


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.detach().clone()


def _batch(x, y, device):
    return (torch.as_tensor(np.asarray(x, np.float32), device=device),
            torch.as_tensor(np.asarray(y), dtype=torch.int64, device=device))


def evaluate_classification_model(apply_fn, params, ls, dataloader,
                                  max_batches=None, verbose=False):
    """Returns (top1, top5, mean loss). (reference: evaluation.py:13-101)"""
    device = _leaves(params)[0].device
    top1s, top5s, losses, ns = [], [], [], []
    with torch.no_grad():
        for i, (x, y) in enumerate(dataloader):
            if max_batches is not None and i >= max_batches:
                break
            x, y = _batch(x, y, device)
            logits = apply_fn(params, ls, x)
            top1s.append(float(get_topk_accuracy(logits, y, 1)))
            top5s.append(float(get_topk_accuracy(logits, y, 5))
                         if logits.shape[-1] >= 5 else 1.0)
            losses.append(float(cross_entropy(logits, y)))
            ns.append(len(y))
    w = np.asarray(ns) / max(1, sum(ns))
    return (float(np.dot(top1s, w)), float(np.dot(top5s, w)),
            float(np.dot(losses, w)))


def train_classification_model(apply_fn, params, ls, train_loader, *,
                               learning_rate=1e-4, max_batches=600,
                               train_scales_only=True, verbose=False):
    """One epoch of Adam on the LSA scales (or all params, the scales
    frozen). Returns (new params, new ls, mean loss, mean top1); the inputs
    are left as they were. As in the reference's step, the loss is the one
    the gradient was taken of and the accuracy that of the updated model on
    the same batch. (reference: train.py:15-83)"""
    params, ls = _clone(params), _clone(ls)
    trainable = ls if train_scales_only else params
    leaves = _leaves(trainable)
    device = leaves[0].device
    adam = Adam(leaves)
    for t in leaves:
        t.requires_grad_(True)

    losses, accs = [], []
    for i, (x, y) in enumerate(train_loader):
        if i >= max_batches:
            break
        x, y = _batch(x, y, device)
        loss = cross_entropy(apply_fn(params, ls, x), y)
        grads = torch.autograd.grad(loss, leaves)
        adam.update(grads, torch.from_numpy(
            Adam.hyper(learning_rate, i)).to(device))
        with torch.no_grad():
            acc = get_topk_accuracy(apply_fn(params, ls, x), y, 1)
        losses.append(float(loss.detach()))
        accs.append(float(acc))
    return (_clone(params), _clone(ls), float(np.mean(losses)),
            float(np.mean(accs)))


class ClassificationExecuter(ModelExecute):
    """LSA/FT/IOQ executer for classifiers.

    model_builder(parameters: flat numpy dict) ->
        (apply_fn(params, ls, x)->logits, params dict, ls dict,
         extract(params, ls) -> flat numpy dict of tuned tensors)
    """

    def __init__(self, model_builder, train_loader_fn, val_loader_fn=None,
                 test_loader_fn=None, *, learning_rate=1e-4, epochs=2,
                 max_batches=600, patience=2, verbose=True):
        self.model_builder = model_builder
        self.train_loader_fn = train_loader_fn
        self.val_loader_fn = val_loader_fn or train_loader_fn
        self.test_loader_fn = test_loader_fn or self.val_loader_fn
        self.learning_rate = learning_rate
        self.epochs = epochs
        self.max_batches = max_batches
        self.patience = patience
        self.verbose = verbose

    def tune_model(self, bitstream_path=None, parameters=None,
                   param_types=None, lsa_flag=True, ft_flag=False,
                   verbose=False):
        apply_fn, params, ls, extract = self.model_builder(parameters)
        best = None
        worse_epochs = 0
        for epoch in range(self.epochs):
            params, ls, loss, acc = train_classification_model(
                apply_fn, params, ls, self.train_loader_fn(),
                learning_rate=self.learning_rate,
                max_batches=self.max_batches,
                train_scales_only=not ft_flag)
            _t1, _t5, vloss = evaluate_classification_model(
                apply_fn, params, ls, self.val_loader_fn(),
                max_batches=self.max_batches)
            if self.verbose:
                print(f"epoch {epoch}: train loss {loss:.4f} acc {acc:.3f} "
                      f"val loss {vloss:.4f}")
            if best is None or vloss < best[0]:  # best-loss checkpointing
                best = (vloss, copy.deepcopy(extract(params, ls)))
                worse_epochs = 0
            else:
                # patience-based early stopping (reference
                # pytorch_model/__init__.py:856-866)
                worse_epochs += 1
                if worse_epochs >= self.patience:
                    if self.verbose:
                        print(f"early stopping after epoch {epoch} "
                              f"(patience {self.patience})")
                    break
        tuned = best[1]
        lsa_params = {k: v for k, v in tuned.items()
                      if k.endswith("weight_scaling")} if lsa_flag else {}
        ft_params = {k: v for k, v in tuned.items()
                     if not k.endswith("weight_scaling")} if ft_flag else {}
        return lsa_params, ft_params

    def eval_model(self, parameters, verbose=False):
        apply_fn, params, ls, _ = self.model_builder(parameters)
        return evaluate_classification_model(
            apply_fn, params, ls, self.val_loader_fn(),
            max_batches=self.max_batches)

    def test_model(self, parameters, verbose=False):
        apply_fn, params, ls, _ = self.model_builder(parameters)
        return evaluate_classification_model(
            apply_fn, params, ls, self.test_loader_fn(),
            max_batches=self.max_batches)

    def has_eval(self):
        return True

    def has_test(self):
        return True

    def has_tune_ft(self):
        return True

    def has_tune_lsa(self):
        return True


def mlp_classifier_builder(layer_prefixes, device=None):
    """Builder factory for simple torch-layout MLP classifiers
    (``{p}.weight``/``.bias``/optionally ``.weight_scaling``): relu between
    layers, logits at the end, the tensors on ``device`` (None: the first
    CUDA device). ``w`` is held as (in, out) and scaled along out, as in the
    reference. Used for tests and as a template."""
    device = resolve_device(device)

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def build(parameters):
        params, ls = {}, {}
        for p in layer_prefixes:
            params[p] = {
                "w": tensor(np.asarray(parameters[p + ".weight"]).T),
                "b": tensor(parameters[p + ".bias"]),
            }
            ls_key = p + ".weight_scaling"
            ls[p] = tensor(np.asarray(parameters[ls_key]).reshape(-1)) \
                if ls_key in parameters else \
                torch.ones(params[p]["w"].shape[1], device=device)

        def apply_fn(params, ls, x):
            h = x
            for i, p in enumerate(layer_prefixes):
                w = params[p]["w"] * ls[p][None, :]
                h = h @ w + params[p]["b"]
                if i < len(layer_prefixes) - 1:
                    h = torch.relu(h)
            return h

        def extract(params, ls):
            out = {}
            for p in layer_prefixes:
                out[p + ".weight"] = \
                    params[p]["w"].detach().cpu().numpy().T.copy()
                out[p + ".bias"] = params[p]["b"].detach().cpu().numpy().copy()
                out[p + ".weight_scaling"] = \
                    ls[p].detach().cpu().numpy().reshape(-1, 1).copy()
            return out

        return apply_fn, params, ls, extract

    return build
