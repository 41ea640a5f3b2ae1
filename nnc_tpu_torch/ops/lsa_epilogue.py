"""K-B7: a layer of LSA as one float32 GEMM and its epilogue kernel.

mip-NeRF 360's MLPs (``models/mipnerf360.py``) are 1,024 and 256 wide: no
kernel of the port holds such a layer's weights in shared memory, as K-B1
holds the 256-wide chain. Each layer runs as one GEMM, ``acc = x @ W^T``
(cuBLAS with TF32 off, the library's float32 product), and K-B7
(``csrc/lsa_epilogue.cu``, launch name ``lsa_epilogue``) applies LSA's
output scale, the bias and the activation in one pass; in the backward it
applies the ReLU mask and the scale and reduces each column's scale and bias
gradient, without a product the size of dW. :func:`scaled_linear` is the
layer: an autograd function whose forward saves the unscaled product
``acc`` and whose backward hands ``dacc @ W`` to the inputs that need it.

On CPU tensors the epilogue's plain versions (:func:`epilogue_fwd_plain`,
:func:`epilogue_bwd_plain`) run in its place.
"""
from __future__ import annotations

import contextlib
from typing import Sequence

import torch

from . import _build

# K-B7 backward: a CTA's columns (4 a lane, or 1 where the width is not a
# multiple of 4) and the chunks of rows its column sums are split into
_CTA_COLUMNS = (128, 32)
_TARGET_CTAS = 1024
_MIN_CHUNK_ROWS = 256


@contextlib.contextmanager
def _fp32_products():
    """TF32 off for cuBLAS's products inside the block, restored after it
    (an error inside propagates and leaves it off)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


def epilogue_fwd_plain(acc, s, b, relu: bool):
    """``act(acc * s + b)``: K-B7's forward in plain PyTorch."""
    z = acc * s + b
    return torch.relu(z) if relu else z


def epilogue_bwd_plain(dy, acc, s, b, relu: bool, want_dacc: bool = True):
    """(dacc, ds, db) of K-B7's backward in plain PyTorch: ``g = dy`` masked
    where ``acc * s + b`` is not positive (ReLU layers), ``dacc = g * s``
    (None unless ``want_dacc``), ``ds = sum_rows g * acc``, ``db = sum_rows
    g``."""
    g = dy * (acc * s + b > 0) if relu else dy
    return (g * s if want_dacc else None), (g * acc).sum(0), g.sum(0)


def _check(name, t, shape):
    if t.dtype != torch.float32 or not t.is_contiguous() or \
            tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected contiguous float32 "
                         f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} "
                         f"contiguous={t.is_contiguous()}")


def backward_chunks(n: int, c: int):
    """(chunks, rows): how K-B7's backward splits ``n`` rows of a width-``c``
    layer for its column sums, about ``_TARGET_CTAS`` CTAs in all, at least
    ``_MIN_CHUNK_ROWS`` rows a chunk."""
    per = _CTA_COLUMNS[0] if c % 4 == 0 else _CTA_COLUMNS[1]
    tiles = -(-c // per)
    chunks = max(1, min(-(-_TARGET_CTAS // tiles),
                        -(-n // _MIN_CHUNK_ROWS)))
    rows = -(-n // chunks)
    return -(-n // rows), rows


def epilogue_fwd(acc, s, b, relu: bool):
    """K-B7 forward: ``act(acc * s + b)`` for acc (n, c), s and b (c,),
    contiguous float32 on one device; CUDA tensors launch the kernel, CPU
    tensors take the plain version."""
    n, c = acc.shape
    for name, t, shape in (("acc", acc, (n, c)), ("s", s, (c,)),
                           ("b", b, (c,))):
        _check(name, t, shape)
    if acc.device.type == "cpu":
        return epilogue_fwd_plain(acc, s, b, relu)
    y = torch.empty_like(acc)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.count_launch("lsa_epilogue")
        _build.check(_build.lib().nnc_lsa_epilogue_fwd(
            acc.data_ptr(), s.data_ptr(), b.data_ptr(), y.data_ptr(), n, c,
            int(bool(relu)), stream), "lsa_epilogue")
    return y


def epilogue_bwd(dy, acc, s, b, relu: bool, want_dacc: bool = True,
                 over_acc: bool = False):
    """K-B7 backward: (dacc, ds, db) as :func:`epilogue_bwd_plain` gives
    them, for dy and acc (n, c), s and b (c,); CUDA tensors launch the
    kernel (its column sums in a fixed order: chunks of rows, then the
    chunks), ``over_acc`` writing dacc over acc; CPU tensors take the plain
    version."""
    n, c = acc.shape
    for name, t, shape in (("dy", dy, (n, c)), ("acc", acc, (n, c)),
                           ("s", s, (c,)), ("b", b, (c,))):
        _check(name, t, shape)
    if acc.device.type == "cpu":
        return epilogue_bwd_plain(dy, acc, s, b, relu, want_dacc)
    chunks, rows = backward_chunks(n, c)
    dacc = (acc if over_acc else torch.empty_like(acc)) if want_dacc \
        else None
    part = torch.empty((chunks, 2, c), dtype=torch.float32,
                       device=acc.device)
    ds = torch.empty_like(s)
    db = torch.empty_like(b)
    with torch.cuda.device(acc.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.count_launch("lsa_epilogue")
        _build.check(_build.lib().nnc_lsa_epilogue_bwd(
            dy.data_ptr(), acc.data_ptr(), s.data_ptr(), b.data_ptr(),
            dacc.data_ptr() if want_dacc else None, part.data_ptr(),
            ds.data_ptr(), db.data_ptr(), n, c, int(bool(relu)), chunks,
            rows, stream), "lsa_epilogue")
    return dacc, ds, db


def _product(xs, weights):
    acc = torch.mm(xs[0], weights[0].t())
    for x, w in zip(xs[1:], weights[1:]):
        acc.addmm_(x, w.t())
    return acc


class _ScaledLinear(torch.autograd.Function):
    """``act((sum_i xs[i] @ weights[i]^T) * s + b)`` with frozen weights:
    the gradients of ``s``, ``b`` and the inputs. The backward writes the
    product's cotangent over the saved product (a 1024-wide layer's is 2 GB
    at 524,288 points), so it runs once: no ``retain_graph``."""

    @staticmethod
    def forward(ctx, s, b, relu, weights, *xs):
        with _fp32_products():
            acc = _product(xs, weights)
        ctx.save_for_backward(acc, s, b)
        ctx.relu, ctx.weights = relu, weights
        return epilogue_fwd(acc, s, b, relu)

    @staticmethod
    def backward(ctx, dy):
        acc, s, b = ctx.saved_tensors
        want = ctx.needs_input_grad[4:]
        dacc, ds, db = epilogue_bwd(dy.contiguous(), acc, s, b, ctx.relu,
                                    want_dacc=any(want), over_acc=True)
        with _fp32_products():
            dxs = [torch.mm(dacc, w) if need else None
                   for need, w in zip(want, ctx.weights)]
        return (ds if ctx.needs_input_grad[0] else None,
                db if ctx.needs_input_grad[1] else None, None, None, *dxs)


def scaled_linear(layer, xs: Sequence[torch.Tensor], relu: bool):
    """One LSA layer through a GEMM and K-B7: ``act(x @ (ls * W)^T + b)``
    for a ``nerf.Linear`` ``layer`` whose input is the concatenation of
    ``xs`` along their last axis, each (n, k_i) float32, its weight split
    by columns to match. The scale is applied to the unscaled product
    (``(x @ W^T) * ls + b``), the form whose autograd gives the scale
    gradient without dW. The weight is frozen (``lsa.trained_tensors``): a
    weight that requires grad while grad is enabled is refused, since the
    layer gives it no gradient."""
    w = layer.weight
    weights = torch.split(w, [x.shape[-1] for x in xs], dim=1) \
        if len(xs) > 1 else (w,)
    s = layer.weight_scaling.reshape(-1) if layer.weight_scaling is not None \
        else torch.ones(w.shape[0], device=w.device)
    if w.requires_grad and torch.is_grad_enabled():
        raise ValueError("K-B7 trains a layer's LSA scale and bias only: "
                         "its weight must not require grad "
                         "(lsa.trained_tensors freezes it)")
    return _ScaledLinear.apply(s, layer.bias, relu, tuple(weights), *xs)
