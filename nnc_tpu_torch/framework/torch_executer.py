"""Executer for arbitrary torch ``nn.Module`` classifiers.

Counterpart of ``nnc_tpu/framework/torch_executer.py``, which runs the same
torch code on the host CPU. The reference builds an ImageNet executer from
any torchvision-style module (reference:
framework/pytorch_model/__init__.py:192-236 and the
ImageNetPytorchModelExecuter at :613-919, patience early stopping
:856-866). Here the module and every batch live on the executer's
``device`` (None: the first CUDA device); the codec side stays unchanged.
Its convolutions and matmuls run in float32 there, as the reference's do on
the host. cuDNN's convolutions default to TF32 on the card, and in TF32 two
tuning steps of a conv net ended as far from the host's result as the steps
moved its tensors (chip_smoke.py, phase 22), so TF32 is off unless the
executer is built with ``allow_tf32``.

LSA scales attach per output channel by wrapping Linear/Conv2d modules
(reference transforms.py:41-111 ScaledConv2d/ScaledLinear semantics). They
are drawn on the CPU from a generator seeded with the executer's seed, which
gives the reference's draws (it seeds torch's global generator), and then
moved to the device.
"""
from __future__ import annotations

import contextlib
import copy
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from ..core.model import ModelExecute
from ..utils.device import resolve_device


def _scales(shape, generator):
    return nn.Parameter(torch.normal(1.0, 1e-5, shape, generator=generator))


class ScaledLinear(nn.Module):
    def __init__(self, inner, generator=None):
        super().__init__()
        self.weight = inner.weight
        self.bias = inner.bias
        self.weight_scaling = _scales((inner.out_features, 1), generator)

    def forward(self, x):
        return nn.functional.linear(x, self.weight_scaling * self.weight,
                                    self.bias)


class ScaledConv2d(nn.Module):
    def __init__(self, inner, generator=None):
        super().__init__()
        self.inner_cfg = (inner.stride, inner.padding, inner.dilation,
                          inner.groups)
        self.padding_mode = inner.padding_mode
        self.pad_twice = tuple(inner._reversed_padding_repeated_twice)
        self.weight = inner.weight
        self.bias = inner.bias
        self.weight_scaling = _scales((inner.out_channels, 1, 1, 1),
                                      generator)

    def forward(self, x):
        s, p, d, g = self.inner_cfg
        w = self.weight_scaling * self.weight
        if self.padding_mode != "zeros":
            # F.conv2d only zero-pads; reflect/replicate/circular pads
            # must be applied explicitly (as nn.Conv2d does internally)
            x = nn.functional.pad(x, self.pad_twice, mode=self.padding_mode)
            p = 0
        return nn.functional.conv2d(x, w, self.bias, stride=s, padding=p,
                                    dilation=d, groups=g)


def add_lsa_scaling(model, max_depth: int = 5,
                    generator: Optional[torch.Generator] = None):
    """Wrap every Linear/Conv2d in ``model`` (in place, to ``max_depth``)
    with a per-output-channel ``weight_scaling`` parameter, N(1, 1e-5^2)
    from ``generator`` (a CPU generator; None: torch's global one), so the
    effective weight is ``ws * W``. Returns the model.
    (reference: transforms.py:113-168 walks named_children to depth 5)"""

    def walk(mod, depth):
        for name, child in mod.named_children():
            if isinstance(child, nn.Linear):
                setattr(mod, name, ScaledLinear(child, generator))
            elif isinstance(child, nn.Conv2d):
                setattr(mod, name, ScaledConv2d(child, generator))
            elif depth > 0:
                walk(child, depth - 1)

    walk(model, max_depth)
    return model


class TorchModuleExecuter(ModelExecute):
    """eval/test/tune for a torch classifier module on ``device``.

    ``train_loader_fn``/``val_loader_fn``/``test_loader_fn`` return iterables
    of (inputs, int labels). Tuning optimizes ``weight_scaling`` (lsa) and/or
    the O_TYPES companions (ft) with Adam, per-epoch StepLR decay, best-loss
    checkpointing and patience-based early stopping (reference :856-866)."""

    def __init__(self, model, train_loader_fn, val_loader_fn=None,
                 test_loader_fn=None, *, learning_rate=1e-4, epochs=2,
                 learning_rate_decay=0.1, max_batches=600, patience=2,
                 lsa: bool = True, channels_last=False, verbose=True,
                 seed=451, device=None, allow_tf32: bool = False):
        self.device = resolve_device(device)
        self.allow_tf32 = allow_tf32
        self.channels_last = channels_last  # loaders yield NHWC -> transpose
        self.model = copy.deepcopy(model)
        if lsa:
            add_lsa_scaling(self.model,
                            generator=torch.Generator().manual_seed(seed))
        self.model.to(self.device)
        self.train_loader_fn = train_loader_fn
        self.val_loader_fn = val_loader_fn or train_loader_fn
        self.test_loader_fn = test_loader_fn or self.val_loader_fn
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.epochs = epochs
        self.max_batches = max_batches
        self.patience = patience
        self.verbose = verbose

    # -- helpers -------------------------------------------------------------
    @contextlib.contextmanager
    def _math(self):
        """cuDNN's convolutions and the matmuls in float32, or in TF32 where
        ``allow_tf32``; the process's settings come back after the block."""
        cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
        with contextlib.ExitStack() as stack:
            stack.callback(setattr, matmul, "allow_tf32", matmul.allow_tf32)
            matmul.allow_tf32 = self.allow_tf32
            stack.enter_context(cudnn.flags(
                enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                deterministic=cudnn.deterministic,
                allow_tf32=self.allow_tf32))
            yield

    def _load(self, parameters):
        ref = self.model.state_dict()
        sd = {k: torch.as_tensor(np.ascontiguousarray(
            np.asarray(v, np.float32))).reshape(ref[k].shape)
            for k, v in parameters.items() if k in ref}
        for k in ref:  # scales default to identity when not provided
            if k not in sd:
                assert k.endswith("weight_scaling"), f"missing parameter {k}"
                sd[k] = torch.ones_like(ref[k])
        self.model.load_state_dict(sd)

    def _as_input(self, x):
        x = np.asarray(x, np.float32)
        if self.channels_last and x.ndim == 4:
            x = x.transpose(0, 3, 1, 2)
        return torch.as_tensor(x, device=self.device)

    def _labels(self, y):
        return torch.as_tensor(np.asarray(y), device=self.device).long()

    def _evaluate(self, loader):
        self.model.eval()
        top1, top5, losses, n = 0.0, 0.0, 0.0, 0
        crit = torch.nn.CrossEntropyLoss(reduction="sum")
        with torch.no_grad():
            for i, (x, y) in enumerate(loader):
                if i >= self.max_batches:
                    break
                x = self._as_input(x)
                y = self._labels(y)
                logits = self.model(x)
                k5 = min(5, logits.shape[-1])
                topk = logits.topk(k5, dim=-1).indices
                top1 += float((topk[:, :1] == y[:, None]).any(1).sum())
                top5 += float((topk == y[:, None]).any(1).sum())
                losses += float(crit(logits, y))
                n += len(y)
        n = max(1, n)
        return top1 / n, top5 / n, losses / n

    # -- ModelExecute --------------------------------------------------------
    def eval_model(self, parameters, verbose=False):
        self._load(parameters)
        with self._math():
            return self._evaluate(self.val_loader_fn())

    def test_model(self, parameters, verbose=False):
        self._load(parameters)
        with self._math():
            return self._evaluate(self.test_loader_fn())

    def tune_model(self, bitstream_path=None, parameters=None,
                   param_types=None, lsa_flag=True, ft_flag=False,
                   verbose=False):
        with self._math():
            return self._tune(parameters, lsa_flag, ft_flag, verbose)

    def _tune(self, parameters, lsa_flag, ft_flag, verbose):
        self._load(parameters)
        if self.device.type == "cpu":
            torch.set_num_threads(1)  # as the reference tunes on the host
        tuning = []
        for name, p in self.model.named_parameters():
            is_ls = name.endswith("weight_scaling")
            trainable = (lsa_flag and is_ls) or \
                (ft_flag and not is_ls and not name.endswith(".weight"))
            p.requires_grad = trainable
            if trainable:
                tuning.append(p)
        opt = torch.optim.Adam(tuning, lr=self.learning_rate)
        sched = None
        if self.learning_rate_decay:
            sched = torch.optim.lr_scheduler.StepLR(
                opt, step_size=1, gamma=self.learning_rate_decay)
        crit = torch.nn.CrossEntropyLoss()

        best_loss, best_sd, worse_epochs = None, None, 0
        for epoch in range(self.epochs):
            self.model.train()
            for i, (x, y) in enumerate(self.train_loader_fn()):
                if i >= self.max_batches:
                    break
                x = self._as_input(x)
                y = self._labels(y)
                loss = crit(self.model(x), y)
                opt.zero_grad()
                loss.backward()
                opt.step()
            if sched is not None:
                sched.step()
            _t1, _t5, vloss = self._evaluate(self.val_loader_fn())
            if self.verbose or verbose:
                print(f"epoch {epoch}: val loss {vloss:.4f}")
            if best_loss is None or vloss < best_loss:
                best_loss = vloss
                best_sd = copy.deepcopy(self.model.state_dict())
                worse_epochs = 0
            else:
                worse_epochs += 1
                if worse_epochs >= self.patience:  # early stopping
                    if self.verbose or verbose:
                        print(f"early stopping after epoch {epoch} "
                              f"(patience {self.patience})")
                    break
        self.model.load_state_dict(best_sd)

        lsa_params, ft_params = {}, {}
        for name, t in best_sd.items():
            if name.endswith("weight_scaling"):
                if lsa_flag:
                    lsa_params[name] = t.cpu().numpy().flatten()
            elif ft_flag and not name.endswith(".weight"):
                ft_params[name] = t.cpu().numpy()
        return lsa_params, ft_params

    def has_eval(self):
        return True

    def has_test(self):
        return True

    def has_tune_ft(self):
        return True

    def has_tune_lsa(self):
        return True


def create_imagenet_model_executer(model, dataset_path, *, batch_size=64,
                                   learning_rate=1e-4, epochs=2,
                                   max_batches=600, lsa=True, verbose=True,
                                   device=None):
    """Build a TorchModuleExecuter over ImageNet-style folder data on
    ``device`` (reference: pytorch_model/__init__.py:192-236)."""
    from ..data.imagenet import imagenet_dataloaders

    train_loader_fn, val_loader_fn = imagenet_dataloaders(
        dataset_path, batch_size=batch_size)
    return TorchModuleExecuter(model, train_loader_fn, val_loader_fn,
                               learning_rate=learning_rate, epochs=epochs,
                               max_batches=max_batches, lsa=lsa,
                               channels_last=True, verbose=verbose,
                               device=device)
