"""Posenc + NeRF MLP for training renders: kernel pair K-B1 and its plain
versions.

Counterpart of ``nnc_tpu/ops/mlp_train_pallas.py``. The LSA scales act as
output scaling, ``u = x @ W``, ``y = u * ls + b`` (relu on the hidden and
view layers), so that the scale gradient is ``dls = colsum(dy_pre * u)``
without any product over the weights. :func:`fused_nerf_mlp_train` is a
``torch.autograd.Function`` over every layer's ``weight``, ``bias`` and
``weight_scaling``:

* the scales and biases always get their gradients; the weights get theirs
  only ``with_dw`` (a zero gradient otherwise: the dW products are the
  expensive part, and which tensors train is the optimizer's choice, as in
  mlp_train_pallas.py:351-356);
* points and view directions get none (they are data);
* configurations other than the flagship take the plain MLP.

The kernels (``csrc/mlp_train.cu``) read three packed buffers:
``params``, the layout of :func:`mlp_fused.pack_weights` without the scales
folded in; ``params_t``, every layer's weight in torch's (out, in) layout,
concatenated in layer order, for the backward's input gradients; ``ls``,
every layer's scales concatenated (the ``U_OFFSETS`` layout, which is also
that of the forward's per-point workspace of ``u`` and of the gradients).
The plain versions read the same buffers, so the CPU tests check the layout
the kernels read. On CPU tensors the wrappers run the plain versions; the
plain backward recomputes the forward, as the TPU kernel does, where the
CUDA forward leaves ``u`` in a workspace for its backward.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models import nerf
from . import _build
from .mlp_fused import (FLAGSHIP, PARAMS_SIZE, PLAIN_CHUNK, _check, _segments,
                        supports, unpack_weights)
from .posenc import positional_encoding

_DIMS = list(nerf._layer_dims(FLAGSHIP).items())   # [(name, (in, out))]
NAMES = [name for name, _ in _DIMS]


def _offsets(sizes):
    out, off = [], 0
    for s in sizes:
        out.append(off)
        off += s
    return out, off


U_OFFSETS, U_SIZE = _offsets([dout for _, (_din, dout) in _DIMS])
WT_OFFSETS, WT_SIZE = _offsets([din * dout for _, (din, dout) in _DIMS])
TILE = 64   # points per CTA; the workspace has rows for whole tiles


def _padded(n: int) -> int:
    return -(-n // TILE) * TILE


def grad_size(with_dw: bool) -> int:
    """Length of the flat gradient: [dW (with_dw), dls, db]."""
    return (WT_SIZE if with_dw else 0) + 2 * U_SIZE


# --------------------------------------------------------------- packing
def pack_train(weights, biases, scales):
    """(params, params_t, ls) from each layer's weight (out, in), bias (out,)
    and scales (out, 1), in layer order."""
    segs, size = _segments(FLAGSHIP)
    ends = [off for *_, off in segs[1:]] + [size]
    parts = []
    with torch.no_grad():
        for w, b, end, (_name, _din, _dout, off) in zip(weights, biases, ends,
                                                        segs):
            wf = w.t().reshape(-1).float()
            parts += [wf, b.float(), wf.new_zeros(end - off - w.numel()
                                                 - b.numel())]
        params = torch.cat(parts)
        params_t = torch.cat([w.reshape(-1).float() for w in weights])
        ls = torch.cat([s.reshape(-1).float() for s in scales])
    return params, params_t, ls


def _layer_tensors(model: nerf.NeRF):
    """Each layer's (weight, bias, scales (out, 1)), ones where a layer has
    no scales, flattened in layer order."""
    out = []
    for layer in model.layers().values():
        ls = layer.weight_scaling
        if ls is None:
            ls = torch.ones(layer.weight.shape[0], 1,
                            device=layer.weight.device)
        out += [layer.weight, layer.bias, ls]
    return out


def _views(flat, offsets, shapes):
    return {name: flat[off:off + shape[0] * shape[1]].view(*shape)
            if len(shape) == 2 else flat[off:off + shape[0]]
            for name, off, shape in zip(NAMES, offsets, shapes)}


def split_grads(flat, with_dw: bool):
    """{name: dW (out, in)} (None without with_dw), {name: dls (out,)},
    {name: db (out,)} from a flat gradient."""
    dw_size = WT_SIZE if with_dw else 0
    outs = [(dout,) for _, (_din, dout) in _DIMS]
    dW = _views(flat, WT_OFFSETS, [(dout, din) for _, (din, dout) in _DIMS]) \
        if with_dw else None
    dls = _views(flat[dw_size:dw_size + U_SIZE], U_OFFSETS, outs)
    db = _views(flat[dw_size + U_SIZE:], U_OFFSETS, outs)
    return dW, dls, db


# --------------------------------------------------------- plain versions
def _unpack(params, ls, params_t=None):
    L = unpack_weights(params)
    S = _views(ls, U_OFFSETS, [(dout,) for _, (_din, dout) in _DIMS])
    WT = None
    if params_t is not None:
        WT = _views(params_t, WT_OFFSETS,
                    [(dout, din) for _, (din, dout) in _DIMS])
    return L, S, WT


def _chain(L, S, pe, ve, keep=False):
    """The training MLP on embedded points in output-scaling form; with
    ``keep`` also what the reverse chain needs (mlp_train_pallas.py
    _fwd_chain)."""
    h_list, u_list = [], []
    x = pe
    for i in range(8):
        name = f"pts_linears.{i}"
        w, b = L[name]
        if i == 5:
            u = pe @ w[:pe.shape[-1]] + x @ w[pe.shape[-1]:]
        else:
            u = x @ w
        x = F.relu(u * S[name] + b)
        h_list.append(x)
        u_list.append(u)
    wa, ba = L["alpha_linear"]
    u_a = x @ wa
    alpha = u_a * S["alpha_linear"] + ba
    wf, bf = L["feature_linear"]
    u_f = x @ wf
    feature = u_f * S["feature_linear"] + bf
    wv, bv = L["views_linears.0"]
    u_v = feature @ wv[:feature.shape[-1]] + ve @ wv[feature.shape[-1]:]
    v = F.relu(u_v * S["views_linears.0"] + bv)
    wr, br = L["rgb_linear"]
    u_r = v @ wr
    rgb = u_r * S["rgb_linear"] + br
    out = torch.cat([rgb, alpha], dim=-1)
    if not keep:
        return out
    return out, dict(h=h_list, u=u_list, u_a=u_a, u_f=u_f, feature=feature,
                     u_v=u_v, v=v, u_r=u_r)


def mlp_train_fwd_plain(params, ls, pts, dirs):
    """Plain PyTorch version of the K-B1 forward: raw (N, 4)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    L, S, _ = _unpack(params, ls)
    outs = [_chain(L, S, positional_encoding(pts[s:s + PLAIN_CHUNK], 10),
                   positional_encoding(dirs[s:s + PLAIN_CHUNK], 4))
            for s in range(0, pts.shape[0], PLAIN_CHUNK)]
    return torch.cat(outs) if outs else pts.new_zeros((0, 4))


def mlp_train_bwd_plain(params, params_t, ls, pts, dirs, g, with_dw: bool):
    """Plain PyTorch version of the K-B1 backward: the explicit reverse chain
    of mlp_train_pallas.py _make_bwd_kernel (the forward recomputed), summed
    over all points. Returns the flat gradient [dW (with_dw: each layer's
    (out, in)), dls, db]."""
    torch.backends.cuda.matmul.allow_tf32 = False
    L, S, WT = _unpack(params, ls, params_t)
    zeros = lambda shape: torch.zeros(shape, device=pts.device)
    dW = {n: zeros((dout, din)) for n, (din, dout) in _DIMS}
    dls = {n: zeros((dout,)) for n, (_din, dout) in _DIMS}
    db = {n: zeros((dout,)) for n, (_din, dout) in _DIMS}
    n_pe = 63

    for s in range(0, pts.shape[0], PLAIN_CHUNK):
        pe = positional_encoding(pts[s:s + PLAIN_CHUNK], 10)
        ve = positional_encoding(dirs[s:s + PLAIN_CHUNK], 4)
        _out, r = _chain(L, S, pe, ve, keep=True)
        gc = g[s:s + PLAIN_CHUNK]
        h = r["h"]

        def layer(name, dy_pre, u, x):
            """Sums of one layer; returns du = dy_pre * ls."""
            dls[name] += (dy_pre * u).sum(0)
            db[name] += dy_pre.sum(0)
            du = dy_pre * S[name]
            if with_dw:
                dW[name] += du.t() @ x()
            return du

        du_r = layer("rgb_linear", gc[:, :3], r["u_r"], lambda: r["v"])
        dv = du_r @ WT["rgb_linear"]
        du_a = layer("alpha_linear", gc[:, 3:], r["u_a"], lambda: h[7])
        dh = du_a @ WT["alpha_linear"]
        du_v = layer("views_linears.0", dv * (r["v"] > 0), r["u_v"],
                     lambda: torch.cat([r["feature"], ve], -1))
        dfeature = du_v @ WT["views_linears.0"][:, :r["feature"].shape[-1]]
        du_f = layer("feature_linear", dfeature, r["u_f"], lambda: h[7])
        dh = dh + du_f @ WT["feature_linear"]
        for i in range(7, -1, -1):
            name = f"pts_linears.{i}"
            x = (lambda: pe) if i == 0 else \
                (lambda: torch.cat([pe, h[4]], -1)) if i == 5 else \
                (lambda i=i: h[i - 1])
            du = layer(name, dh * (h[i] > 0), r["u"][i], x)
            if i > 0:
                dh = du @ (WT[name][:, n_pe:] if i == 5 else WT[name])

    parts = [dW[n].reshape(-1) for n in NAMES] if with_dw else []
    parts += [dls[n] for n in NAMES] + [db[n] for n in NAMES]
    return torch.cat(parts)


# ------------------------------------------------------------ the kernels
def _check_inputs(params, ls, pts, dirs):
    n = pts.shape[0]
    _check("params", params, (PARAMS_SIZE,))
    _check("ls", ls, (U_SIZE,))
    _check("pts", pts, (n, 3))
    _check("dirs", dirs, (n, 3))
    if not (params.device == ls.device == pts.device == dirs.device):
        raise ValueError("params, ls, pts and dirs must be on one device")
    if pts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {pts.device}")
    return n


def mlp_train_fwd(params, ls, pts, dirs, save_u: bool = False):
    """K-B1 forward wrapper: (raw (N, 4), workspace). With ``save_u`` the
    kernel also writes every layer's u per point, (ceil(N / 64) * 64,
    U_SIZE), for :func:`mlp_train_bwd`; else the workspace is None. CPU
    tensors take the plain version (no workspace)."""
    n = _check_inputs(params, ls, pts, dirs)
    if pts.device.type == "cpu":
        return mlp_train_fwd_plain(params, ls, pts, dirs), None
    lib = _build.lib()
    out = torch.empty((n, 4), dtype=torch.float32, device=pts.device)
    ws = torch.empty((_padded(n), U_SIZE), dtype=torch.float32,
                     device=pts.device) if save_u else None
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.count_launch("mlp_train_fwd")
        _build.check(lib.nnc_mlp_train_fwd(
            params.data_ptr(), ls.data_ptr(), pts.data_ptr(), dirs.data_ptr(),
            out.data_ptr(), None if ws is None else ws.data_ptr(), n, stream),
            "mlp_train_fwd")
    return out, ws


def mlp_train_bwd(params, params_t, ls, pts, dirs, g, ws, with_dw: bool):
    """K-B1 backward wrapper: the flat gradient [dW (with_dw), dls, db] for
    the raw cotangent ``g`` (N, 4). CUDA tensors need the forward's
    workspace ``ws``; CPU tensors take the plain version."""
    n = _check_inputs(params, ls, pts, dirs)
    _check("params_t", params_t, (WT_SIZE,))
    _check("g", g, (n, 4))
    if not (params_t.device == g.device == pts.device):
        raise ValueError("params_t, g and pts must be on one device")
    if pts.device.type == "cpu":
        return mlp_train_bwd_plain(params, params_t, ls, pts, dirs, g,
                                   with_dw)
    if ws is None:
        raise ValueError("the CUDA backward needs the forward's workspace "
                         "(mlp_train_fwd(save_u=True))")
    _check("ws", ws, (_padded(n), U_SIZE))
    lib = _build.lib()
    sms = torch.cuda.get_device_properties(pts.device).multi_processor_count
    grid = min(_padded(n) // TILE, sms)
    size = grad_size(with_dw)
    partials = torch.empty((grid, size), dtype=torch.float32,
                           device=pts.device)
    out = torch.empty((size,), dtype=torch.float32, device=pts.device)
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.count_launch("mlp_train_bwd")
        _build.check(lib.nnc_mlp_train_bwd(
            params.data_ptr(), params_t.data_ptr(), ls.data_ptr(),
            pts.data_ptr(), dirs.data_ptr(), g.data_ptr(), ws.data_ptr(),
            partials.data_ptr(), out.data_ptr(), n, grid, int(with_dw),
            stream), "mlp_train_bwd")
    return out


class _TrainMLP(torch.autograd.Function):
    """raw = MLP(pts, dirs) over the flat per-layer (weight, bias, scales)."""

    @staticmethod
    def forward(ctx, pts, dirs, with_dw, *tensors):
        weights = tensors[0::3]
        params, _, ls = pack_train(weights, tensors[1::3], tensors[2::3])
        raw, ws = mlp_train_fwd(params, ls, pts, dirs,
                                save_u=pts.device.type == "cuda")
        ctx.with_dw = with_dw
        ctx.scale_shapes = [t.shape for t in tensors[2::3]]
        ctx.save_for_backward(pts, dirs, params, ls, *weights,
                              *([] if ws is None else [ws]))
        return raw

    @staticmethod
    def backward(ctx, g):
        pts, dirs, params, ls, *rest = ctx.saved_tensors
        weights, ws = rest[:len(NAMES)], (rest[len(NAMES):] or [None])[0]
        params_t = torch.cat([w.reshape(-1).float() for w in weights])
        flat = mlp_train_bwd(params, params_t, ls, pts, dirs,
                             g.float().contiguous(), ws, ctx.with_dw)
        dW, dls, db = split_grads(flat, ctx.with_dw)
        need = ctx.needs_input_grad[3:]
        grads = []
        for i, name in enumerate(NAMES):
            gw = dW[name] if dW is not None else torch.zeros_like(weights[i])
            grads += [gw if need[3 * i] else None,
                      db[name] if need[3 * i + 1] else None,
                      dls[name].reshape(ctx.scale_shapes[i])
                      if need[3 * i + 2] else None]
        return (None, None, None, *grads)


def fused_nerf_mlp_train(model: nerf.NeRF, pts, viewdirs,
                         with_dw: bool = False):
    """Differentiable posenc + MLP from raw points (training renders).

    pts: (..., 3); viewdirs broadcastable to pts. Returns raw (..., 4)
    float32, with gradients for every layer's ``weight_scaling`` and
    ``bias``, and for ``weight`` only ``with_dw``. Non-flagship
    configurations take the plain MLP (output-scaling form)."""
    vd = torch.broadcast_to(viewdirs, pts.shape)
    if not supports(model.config):
        return nerf.apply_mlp(model, positional_encoding(pts, 10),
                              positional_encoding(vd, 4), output_scaling=True)
    lead = pts.shape[:-1]
    raw = _TrainMLP.apply(pts.detach().reshape(-1, 3).float().contiguous(),
                          vd.detach().reshape(-1, 3).float().contiguous(),
                          with_dw, *_layer_tensors(model))
    return raw.reshape(*lead, 4)
