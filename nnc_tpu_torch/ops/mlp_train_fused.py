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

The forward and the backward run their products on the tensor cores as
three TF32 products each, warpgroup ``wgmma`` (``csrc/mlp_train.cu`` on
``csrc/mlp_train_wgmma.cuh``), and read B as shared-memory images,
:func:`pack_train_wgmma`: every weight split once into hi (TF32) and lo,
the unscaled (in, out) weights for the forward, and torch's (out, in)
weights, B of ``dx = du @ W^T``, as a second stream of slabs for the
backward. Both depend on the twelve weight tensors only, which LSA
and fine-tuning without dW never change, so :data:`TRAIN_PACKS` keeps them
from step to step; the scales and biases go in as two vectors in the
``U_OFFSETS`` layout, which is also that of the forward's per-point
workspace of ``u`` and of the gradients. The backward with dW is two
passes: the same backward also writes every layer's du to a second
workspace, and a GEMM over the points (``csrc/mlp_train_dw.cu``) sums
dW = X^T dU from it and from the workspace of u, in fixed chunks of
DW_CHUNK points (:func:`mlp_train_dw_plain` is its plain version). The
plain versions read the buffers of :func:`pack_train`: ``params``, the
layout of :func:`mlp_fused.pack_weights` without the scales folded in;
``params_t``, every layer's weight in (out, in), concatenated in layer
order; ``ls``. :func:`unpack_train_wgmma` reads the images back, so the
CPU tests check the layouts the kernels read;
:func:`mlp_train_fwd_3xtf32_plain` and :func:`mlp_train_bwd_3xtf32_plain`
model the tensor-core arithmetic. On CPU tensors the wrappers run the
plain versions; the plain backward recomputes the forward, as the TPU
kernel does, where the CUDA forward leaves ``u`` in a workspace for its
backward.

A model with ``config.compute_dtype == torch.bfloat16`` takes K-B1's bf16
form (mlp_train_pallas.py:380): the UNSCALED weights, the embedding and
every stored activation rounded to bf16, ``u`` summed in float32 and scaled
in float32, every du rounded before it enters a product, dW rounded once
summed. Its kernels (``csrc/mlp_train_bf16.cu``, and with dW the same
GEMM on a bf16 du workspace) are :func:`mlp_train_fwd_bf16` /
:func:`mlp_train_bwd_bf16`, reading :func:`pack_train_bf16`'s two int32
streams, which :data:`TRAIN_PACKS` keeps under the compute type; the plain
versions :func:`mlp_train_fwd_bf16_plain` / :func:`mlp_train_bwd_bf16_plain`
are the float32 ones with the rounding hook ``rnd`` on the rounded weights.
"""
from __future__ import annotations

import collections

import numpy as np
import torch
import torch.nn.functional as F

from ..models import nerf
from . import _build
from .mlp_fused import (BF16_PARAMS_SIZE, FLAGSHIP, MMA_RUNS, MMA_SLAB,
                        PARAMS_SIZE, PLAIN_CHUNK, _check, _segments,
                        bf16_round, fragment_index_k16, matmul_3xtf32_plain,
                        repack_bf16, supports, tf32_round, unpack_weights,
                        unpack_weights_bf16)
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
# points per CTA of the bf16 forward (csrc/mlp_train_bf16.cu); its workspace
# has rows for whole tiles of this size, its backward walks tiles of TILE
TILE_BF16 = 128
# points of a CTA of the weight gradient's GEMM (csrc/mlp_train_dw.cu): its
# partial dW are summed over chunks of this size, in chunk order
DW_CHUNK = 4096
DW_BLOCK = 32   # points whose products sum in a tile of their own
# columns of the bf16 du workspace: U_SIZE rounded up to 8, so that every row
# starts 16-byte aligned (the float32 one has U_SIZE)
DU_COLS_BF16 = -(-U_SIZE // 8) * 8


def _padded(n: int, tile: int = TILE) -> int:
    return -(-n // tile) * tile


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


# --- the tensor-core kernels' weights (csrc/mlp_train.cu) ------------------
# The backward's runs, in the order the reverse chain consumes them: (layer,
# first input column, input columns). dx = du @ W^T reads torch's (out, in)
# weight as B of (out rows, in columns); the view layer passes a gradient to
# its 256 feature inputs only, layer 5 to its 256 inputs from h (not to the
# embedding), layer 0 to none. The bf16 backward walks the same runs.
BWD_RUNS = ([("views_linears.0", 0, 256), ("feature_linear", 0, 256)]
            + [(f"pts_linears.{i}", 63 if i == 5 else 0, 256)
               for i in range(7, 0, -1)])

# Both float32 kernels read B of their wgmma products as shared-memory
# images (csrc/mlp_train_wgmma.cuh), made here once a pack: every weight
# split into hi, rounded to TF32 (mlp_fused.tf32_round, as the kernels split
# A), and lo = w - hi, exact, so that hi + lo == w. A group of 32 input
# channels is one image of each, n_out rows of 32 values (128 bytes), row n
# at n * 128 bytes with its 16-byte chunk c at chunk c ^ (n & 7) (the
# 128-byte swizzle), depth position p holding the group's channel
# GROUP_CHANNEL[p] (the order of the kernels' A registers). A slab (8,192
# floats, one bulk copy) is the hi or the lo image of a 256-wide layer's
# group, or both of the 128-wide view layer's. The forward's buffer: the
# MMA_RUNS of the unscaled weights (in, out), 145 slabs, then alpha's 256
# weights and rgb's (128, 3); the backward's: the BWD_RUNS, 136 slabs, then
# alpha's 256 weights and rgb's (3, 128).
WG_SLAB = 8192
FWD_WG_SLABS = 145
BWD_WG_SLABS = 136
_p = np.arange(32)
GROUP_CHANNEL = (16 * (_p >> 4) + 4 * (_p & 3) + 2 * ((_p >> 3) & 1)
                 + ((_p >> 2) & 1))


def wgmma_offsets(n_out):
    """(32, n_out): the float offset, within a group's image of n_out rows,
    of depth position p of row n."""
    p = np.arange(32)[:, None]
    n = np.arange(n_out)[None, :]
    return n * 32 + (((p >> 2) ^ (n & 7)) << 2) + (p & 3)


def _wgmma_index(runs, tails, size):
    """For every float of a buffer, the index of its value in [w, hi(w),
    lo(w), 0] of a flat source w of ``size`` floats. runs: (n_out, src)
    with src (depth, n_out) the source index of B's every value (``size``
    for a zero row); tails: source indices of the raw values after the
    slabs."""
    zero = 3 * size
    parts = []
    for n_out, src in runs:
        pos = wgmma_offsets(n_out).reshape(-1)
        for g0 in range(0, src.shape[0], 32):
            block = src[g0 + GROUP_CHANNEL].reshape(-1)
            for part in (1, 2):   # hi, then lo
                image = np.empty(32 * n_out, dtype=np.int64)
                image[pos] = np.where(block < size, part * size + block, zero)
                parts.append(image)
    tail = np.concatenate(tails)
    parts += [tail, np.full(-tail.size % 64, zero)]
    return np.concatenate(parts).astype(np.int64)


def _fwd_wgmma_index():
    segs = {name: (din, dout, off) for name, din, dout, off
            in _segments(FLAGSHIP)[0]}
    runs = []
    for name, row0, rows, padded in MMA_RUNS:
        _din, dout, off = segs[name]
        k = np.arange(padded)[:, None]
        runs.append((dout, np.where(k < rows, off + (row0 + k) * dout
                                    + np.arange(dout)[None, :], PARAMS_SIZE)))
    tails = [segs[name][2] + np.arange(segs[name][0] * segs[name][1])
             for name in ("alpha_linear", "rgb_linear")]
    return _wgmma_index(runs, tails, PARAMS_SIZE)


def _bwd_wgmma_index():
    dims = dict(_DIMS)
    runs = []
    for name, col0, n_in in BWD_RUNS:
        din, dout = dims[name]
        off = WT_OFFSETS[NAMES.index(name)]
        runs.append((n_in, off + np.arange(dout)[:, None] * din + col0
                     + np.arange(n_in)[None, :]))
    tails = [WT_OFFSETS[NAMES.index(name)] + np.arange(np.prod(dims[name]))
             for name in ("alpha_linear", "rgb_linear")]
    return _wgmma_index(runs, tails, WT_SIZE)


FWD_WG_INDEX = _fwd_wgmma_index()
BWD_WG_INDEX = _bwd_wgmma_index()
FWD_WG_SIZE = FWD_WG_INDEX.size
BWD_WG_SIZE = BWD_WG_INDEX.size
assert FWD_WG_SIZE == FWD_WG_SLABS * WG_SLAB + 640 \
    and BWD_WG_SIZE == BWD_WG_SLABS * WG_SLAB + 640
# every layer's bias in ``params``, in the U_OFFSETS layout
BIAS_INDEX = np.concatenate([off + din * dout + np.arange(dout)
                             for _name, din, dout, off
                             in _segments(FLAGSHIP)[0]]).astype(np.int64)
_index_on = {}   # (which, device) -> the index as a tensor there


def _gather(flat, which, index):
    key = (which, flat.device)
    if key not in _index_on:
        _index_on[key] = torch.from_numpy(index).to(flat.device)
    return flat[_index_on[key]]


def _split_source(flat):
    hi = tf32_round(flat)
    return torch.cat([flat, hi, flat - hi, flat.new_zeros(1)])


def repack_wgmma(params: torch.Tensor) -> torch.Tensor:
    """``params`` (pack_train's layout) as the forward reads it: its
    weights split and laid out as the forward's wgmma images, then the
    heads' weights. One split and one gather."""
    _check("params", params, (PARAMS_SIZE,))
    return _gather(_split_source(params), "fwd_wg", FWD_WG_INDEX)


def repack_wgmma_t(params_t: torch.Tensor) -> torch.Tensor:
    """``params_t`` (every layer's (out, in) weight, concatenated) as the
    backward without dW reads it: the BWD_RUNS split and laid out as wgmma
    images, then the heads' weights."""
    _check("params_t", params_t, (WT_SIZE,))
    return _gather(_split_source(params_t), "bwd_wg", BWD_WG_INDEX)


def gather_biases(params: torch.Tensor) -> torch.Tensor:
    """Every layer's bias out of ``params``, concatenated (U_OFFSETS)."""
    return _gather(params, "bias", BIAS_INDEX)


def pack_train_wgmma(weights):
    """(forward buffer, backward buffer) of the tensor-core kernels from each
    layer's weight (out, in), in layer order: :func:`repack_wgmma` of the
    unscaled weights and :func:`repack_wgmma_t`."""
    zeros = [w.new_zeros(w.shape[0]) for w in weights]
    params, params_t, _ = pack_train(weights, zeros, zeros)
    return repack_wgmma(params), repack_wgmma_t(params_t)


def _unsplit(buf, index, size):
    """The flat source of a wgmma buffer read back: hi + lo where the buffer
    holds a value's halves, the raw value where it holds it whole, zeros
    where it holds nothing."""
    dev = buf.device
    idx = torch.from_numpy(index).to(dev)
    flat = buf.new_zeros(size)
    whole = idx < size
    flat[idx[whole]] = buf[whole]
    for part in (1, 2):
        mine = (idx >= part * size) & (idx < (part + 1) * size)
        flat.index_add_(0, idx[mine] - part * size, buf[mine])
    return flat


def unpack_train_wgmma(packed_fwd, packed_bwd):
    """({name: w (in, out)}, {name: w (out, in)}) read back from the buffers
    of :func:`pack_train_wgmma` (hi + lo of every split weight). The second
    holds zeros where the backward has no use for a weight (layer 0, the
    embedding columns of layer 5 and the view columns of the view layer)."""
    _check("packed_fwd", packed_fwd, (FWD_WG_SIZE,))
    _check("packed_bwd", packed_bwd, (BWD_WG_SIZE,))
    fwd = {name: w for name, (w, _b) in unpack_weights(
        _unsplit(packed_fwd, FWD_WG_INDEX, PARAMS_SIZE)).items()}
    return fwd, _views(_unsplit(packed_bwd, BWD_WG_INDEX, WT_SIZE),
                       WT_OFFSETS, [(dout, din) for _, (din, dout) in _DIMS])


# --- the bf16 kernels' weights (csrc/mlp_train_bf16.cu) -----------------------
# K-B1 in bf16 rounds the UNSCALED weights (mlp_train_pallas.py:77) and scales
# u in float32 afterwards: its forward reads repack_bf16 of pack_train's
# buffer (the order of mlp_fused.pack_weights_bf16, whose scales are folded
# in, so that buffer is not this one), its backward the BWD_RUNS slabs in
# the m16n8k16 fragment order (mlp_fused.fragment_index_k16; 64 rows of 256
# outputs a slab: 2 for the view layer, 4 for each of the other eight runs),
# then alpha's 256 weights and rgb's (3, 128), rounded, as float32 words.
BWD_BF16_SLABS = 34


def _bwd_bf16_index():
    """(index of every bf16 value of the backward's slabs, index of every
    float32 word after them) into ``params_t``; WT_SIZE (a zero) for the
    padding words at the end."""
    dims = dict(_DIMS)
    slabs = np.concatenate([
        fragment_index_k16(WT_OFFSETS[NAMES.index(name)] + col0, din, dout,
                           dout, n_in, WT_SIZE)
        for name, col0, n_in in BWD_RUNS
        for din, dout in [dims[name]]]).astype(np.int64)
    tail = np.concatenate([WT_OFFSETS[NAMES.index(name)]
                           + np.arange(np.prod(dims[name]))
                           for name in ("alpha_linear", "rgb_linear")])
    tail = np.concatenate([tail, np.full(-(slabs.size // 2 + tail.size) % 64,
                                         WT_SIZE)])
    return slabs, tail.astype(np.int64)


BWD_BF16_SLAB_INDEX, BWD_BF16_TAIL_INDEX = _bwd_bf16_index()
BWD_BF16_PARAMS_SIZE = BWD_BF16_SLAB_INDEX.size // 2 + BWD_BF16_TAIL_INDEX.size
assert BWD_BF16_SLAB_INDEX.size == 2 * BWD_BF16_SLABS * MMA_SLAB \
    and BWD_BF16_PARAMS_SIZE % 64 == 0


def repack_bf16_t(params_t: torch.Tensor) -> torch.Tensor:
    """``params_t`` as the bf16 backward without dW reads it: int32
    (BWD_BF16_PARAMS_SIZE,), every weight rounded to bf16 (nearest even),
    the slabs two values to a word, the heads as float32 bit patterns."""
    _check("params_t", params_t, (WT_SIZE,))
    rounded = torch.cat([params_t, params_t.new_zeros(1)]).to(torch.bfloat16)
    slabs = _gather(rounded, "bwd_bf16", BWD_BF16_SLAB_INDEX)
    tail = _gather(rounded.float(), "bwd_bf16_tail", BWD_BF16_TAIL_INDEX)
    return torch.cat([slabs.view(torch.int32), tail.view(torch.int32)])


def pack_train_bf16(weights):
    """(forward buffer, backward buffer) of the bf16 kernels from each
    layer's weight (out, in), in layer order: :func:`mlp_fused.repack_bf16`
    of the unscaled weights (its bias block left zero: the biases go to the
    kernel as a vector) and :func:`repack_bf16_t`. Both int32."""
    zeros = [w.new_zeros(w.shape[0]) for w in weights]
    params, params_t, _ = pack_train(weights, zeros, zeros)
    return repack_bf16(params), repack_bf16_t(params_t)


def unpack_train_bf16(packed_fwd, packed_bf16_t):
    """({name: w (in, out)}, {name: w (out, in)}) read back from the buffers
    of :func:`pack_train_bf16`, as float32 tensors holding bf16 values; the
    second with zeros where the backward has no use for a weight, as in
    :func:`unpack_train_wgmma`."""
    fwd = {name: w for name, (w, _b)
           in unpack_weights_bf16(packed_fwd).items()}
    _check("packed_bf16_t", packed_bf16_t, (BWD_BF16_PARAMS_SIZE,),
           torch.int32)
    n_slab = BWD_BF16_SLAB_INDEX.size // 2
    dev = packed_bf16_t.device
    flat = packed_bf16_t.new_zeros(WT_SIZE + 1, dtype=torch.float32)
    flat[torch.from_numpy(BWD_BF16_SLAB_INDEX).to(dev)] = \
        packed_bf16_t[:n_slab].view(torch.bfloat16).float()
    flat[torch.from_numpy(BWD_BF16_TAIL_INDEX).to(dev)] = \
        packed_bf16_t[n_slab:].view(torch.float32)
    return fwd, _views(flat[:WT_SIZE], WT_OFFSETS,
                       [(dout, din) for _, (din, dout) in _DIMS])


_PACKERS = {torch.float32: pack_train_wgmma, torch.bfloat16: pack_train_bf16}


class TrainPackCache:
    """The kernels' weight buffers of a model's twelve weight tensors for a
    compute type (:func:`pack_train_wgmma` for float32, :func:`pack_train_bf16`
    for bfloat16), kept while the tensors stay what they were: the same
    tensor objects at the same version (``Tensor._version``, which every
    in-place update bumps), on the same device and storage. The type is part
    of the key, so a float32 and a bf16 model over the same tensors never
    share a buffer; scales and biases are not, so an LSA run packs once. An
    entry holds its tensors, so their ids cannot pass to other objects while
    it lives; the ``size`` most recently used entries are kept. The cached
    buffers are shared between calls: read them, never write them."""

    def __init__(self, size: int = 8):
        self._entries = collections.OrderedDict()
        self._size = size
        self.hits = 0
        self.misses = 0

    def get(self, weights, dtype: torch.dtype = torch.float32):
        weights = tuple(weights)
        key = (dtype, *(id(w) for w in weights))
        state = [(w._version, w.device, w.data_ptr()) for w in weights]
        entry = self._entries.get(key)
        if entry is not None and entry[1] == state:
            self.hits += 1
            self._entries.move_to_end(key)
            return entry[2]
        self.misses += 1
        value = _PACKERS[dtype](weights)
        self._entries[key] = (weights, state, value)
        self._entries.move_to_end(key)   # also when the key was there
        while len(self._entries) > self._size:
            self._entries.popitem(last=False)
        return value

    def entries(self) -> list:
        """The cached buffers, each entry's value: a holder of this list
        keeps them alive after the cache lets them go (a CUDA graph that
        read them)."""
        return [entry[2] for entry in self._entries.values()]


TRAIN_PACKS = TrainPackCache()


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


def _chain(L, S, pe, ve, keep=False, mm=torch.matmul, rnd=None):
    """The training MLP on embedded points in output-scaling form; with
    ``keep`` also what the reverse chain needs (mlp_train_pallas.py
    _fwd_chain). ``mm(x, w)`` computes the products of the ten wide layers,
    the two small heads are plain float32 products. ``rnd``, if given,
    rounds what the bf16 chain stores in bf16: every hidden layer's output
    after its ReLU, ``feature`` and the view layer's output
    (mlp_train_pallas.py:121, 128, 132); the caller rounds the weights and
    the embeddings, so that every product, the heads' too, multiplies bf16
    values, exactly in float32."""
    q = rnd or (lambda t: t)
    h_list, u_list = [], []
    x = pe
    for i in range(8):
        name = f"pts_linears.{i}"
        w, b = L[name]
        if i == 5:
            u = mm(pe, w[:pe.shape[-1]]) + mm(x, w[pe.shape[-1]:])
        else:
            u = mm(x, w)
        x = q(F.relu(u * S[name] + b))
        h_list.append(x)
        u_list.append(u)
    wa, ba = L["alpha_linear"]
    u_a = x @ wa
    alpha = u_a * S["alpha_linear"] + ba
    wf, bf = L["feature_linear"]
    u_f = mm(x, wf)
    feature = q(u_f * S["feature_linear"] + bf)
    wv, bv = L["views_linears.0"]
    u_v = mm(feature, wv[:feature.shape[-1]]) + mm(ve, wv[feature.shape[-1]:])
    v = q(F.relu(u_v * S["views_linears.0"] + bv))
    wr, br = L["rgb_linear"]
    u_r = v @ wr
    rgb = u_r * S["rgb_linear"] + br
    out = torch.cat([rgb, alpha], dim=-1)
    if not keep:
        return out
    return out, dict(h=h_list, u=u_list, u_a=u_a, u_f=u_f, feature=feature,
                     u_v=u_v, v=v, u_r=u_r)


def mlp_train_fwd_plain(params, ls, pts, dirs, mm=torch.matmul, rnd=None):
    """Plain PyTorch version of the K-B1 forward: raw (N, 4). ``mm``,
    ``rnd``: as in :func:`_chain`; ``rnd`` also rounds the embeddings."""
    torch.backends.cuda.matmul.allow_tf32 = False
    L, S, _ = _unpack(params, ls)
    q = rnd or (lambda t: t)
    outs = [_chain(L, S, q(positional_encoding(pts[s:s + PLAIN_CHUNK], 10)),
                   q(positional_encoding(dirs[s:s + PLAIN_CHUNK], 4)), mm=mm,
                   rnd=rnd)
            for s in range(0, pts.shape[0], PLAIN_CHUNK)]
    return torch.cat(outs) if outs else pts.new_zeros((0, 4))


_is_bias_on = {}   # device -> bool mask of the biases in ``params``


def round_weights_bf16(params, params_t=None):
    """``params`` with every weight rounded to bf16 and the biases left
    float32, and ``params_t`` (if given) rounded: the values the bf16
    kernels read, as float32 tensors."""
    mask = _is_bias_on.get(params.device)
    if mask is None:
        mask = _is_bias_on[params.device] = torch.zeros(
            PARAMS_SIZE, dtype=torch.bool, device=params.device)
        mask[torch.from_numpy(BIAS_INDEX).to(params.device)] = True
    rounded = torch.where(mask, params, bf16_round(params))
    return rounded, None if params_t is None else bf16_round(params_t)


def mlp_train_fwd_bf16_plain(params, ls, pts, dirs):
    """Plain PyTorch version of the K-B1 forward in bf16 (mlp_train_pallas.py
    _fwd_chain with cdt bfloat16): raw (N, 4) float32 from ``params`` and
    ``ls`` as :func:`pack_train` gives them. The unscaled weights and the
    embeddings (computed in float32) are rounded to bf16, u = x @ W is summed
    in float32, ``u * ls + b`` in float32, and every activation that the
    chain stores is rounded (:func:`_chain`'s ``rnd``)."""
    return mlp_train_fwd_plain(round_weights_bf16(params)[0], ls, pts, dirs,
                               rnd=bf16_round)


def mlp_train_fwd_3xtf32_plain(params, ls, pts, dirs):
    """The K-B1 forward as the tensor-core kernel computes it: every product
    of the ten wide layers through :func:`mlp_fused.matmul_3xtf32_plain`,
    the heads in float32. For the tests; nothing on the main path calls it."""
    return mlp_train_fwd_plain(params, ls, pts, dirs, mm=matmul_3xtf32_plain)


def mlp_train_bwd_3xtf32_plain(params, params_t, ls, pts, dirs, g):
    """The K-B1 backward without dW as the tensor-core kernel computes it:
    the forward of :func:`mlp_train_fwd_3xtf32_plain` and every ``du @ W^T``
    of the wide layers through :func:`mlp_fused.matmul_3xtf32_plain` (the
    rank-1 alpha term and the rgb head's 3 x 128 in float32). Returns
    [dls, db]."""
    return mlp_train_bwd_plain(params, params_t, ls, pts, dirs, g, False,
                               mm=matmul_3xtf32_plain)


def mlp_train_bwd_bf16_plain(params, params_t, ls, pts, dirs, g,
                             with_dw: bool):
    """Plain PyTorch version of the K-B1 backward in bf16 (mlp_train_pallas.py
    _make_bwd_kernel and _train_op_bwd with cdt bfloat16), with or without
    dW: the forward of :func:`mlp_train_fwd_bf16_plain` recomputed, the
    weights rounded, the masks taken from the rounded activations, every du
    rounded to bf16 before it enters a product (``bdot``, ``tdot``: dx and
    dW alike), dls and db float32 sums, and dW rounded to bf16 once summed
    over all points (``dW.astype(bfloat16)``, :358). Returns the flat
    gradient [dW (with_dw), dls, db]."""
    params_r, params_t_r = round_weights_bf16(params, params_t)
    return mlp_train_bwd_plain(params_r, params_t_r, ls, pts, dirs, g,
                               with_dw, rnd=bf16_round)


def mlp_train_bwd_plain(params, params_t, ls, pts, dirs, g, with_dw: bool,
                        mm=torch.matmul, rnd=None, workspaces=None):
    """Plain PyTorch version of the K-B1 backward: the explicit reverse chain
    of mlp_train_pallas.py _make_bwd_kernel (the forward recomputed), summed
    over all points. Returns the flat gradient [dW (with_dw: each layer's
    (out, in)), dls, db]. ``mm``: as in :func:`_chain`, for the forward's
    wide products and the reverse chain's. ``rnd``: as in
    :func:`mlp_train_fwd_plain` for the forward, and it rounds every du
    before its products and the summed dW (the bf16 form; the caller rounds
    the weights). ``workspaces``: None, or (ws, du) tensors of (N, U_SIZE)
    or more rows that take every layer's u and du per point."""
    torch.backends.cuda.matmul.allow_tf32 = False
    q = rnd or (lambda t: t)
    L, S, WT = _unpack(params, ls, params_t)
    zeros = lambda shape: torch.zeros(shape, device=pts.device)
    dW = {n: zeros((dout, din)) for n, (din, dout) in _DIMS}
    dls = {n: zeros((dout,)) for n, (_din, dout) in _DIMS}
    db = {n: zeros((dout,)) for n, (_din, dout) in _DIMS}
    n_pe = 63

    for s in range(0, pts.shape[0], PLAIN_CHUNK):
        pe = q(positional_encoding(pts[s:s + PLAIN_CHUNK], 10))
        ve = q(positional_encoding(dirs[s:s + PLAIN_CHUNK], 4))
        _out, r = _chain(L, S, pe, ve, keep=True, mm=mm, rnd=rnd)
        gc = g[s:s + PLAIN_CHUNK]
        h = r["h"]

        def layer(name, dy_pre, u, x):
            """Sums of one layer; returns du = dy_pre * ls, as the products
            take it."""
            dls[name] += (dy_pre * u).sum(0)
            db[name] += dy_pre.sum(0)
            du = q(dy_pre * S[name])
            if with_dw:
                dW[name] += du.t() @ x()
            if workspaces is not None:
                c = U_OFFSETS[NAMES.index(name)]
                for t, v in zip(workspaces, (u, du)):
                    t[s:s + v.shape[0], c:c + v.shape[1]] = v
            return du

        du_r = layer("rgb_linear", gc[:, :3], r["u_r"], lambda: r["v"])
        dv = du_r @ WT["rgb_linear"]
        du_a = layer("alpha_linear", gc[:, 3:], r["u_a"], lambda: h[7])
        dh = du_a @ WT["alpha_linear"]
        du_v = layer("views_linears.0", dv * (r["v"] > 0), r["u_v"],
                     lambda: torch.cat([r["feature"], ve], -1))
        dfeature = mm(du_v,
                      WT["views_linears.0"][:, :r["feature"].shape[-1]])
        du_f = layer("feature_linear", dfeature, r["u_f"], lambda: h[7])
        dh = dh + mm(du_f, WT["feature_linear"])
        for i in range(7, -1, -1):
            name = f"pts_linears.{i}"
            x = (lambda: pe) if i == 0 else \
                (lambda: torch.cat([pe, h[4]], -1)) if i == 5 else \
                (lambda i=i: h[i - 1])
            du = layer(name, dh * (h[i] > 0), r["u"][i], x)
            if i > 0:
                dh = mm(du, WT[name][:, n_pe:] if i == 5 else WT[name])

    parts = [q(dW[n]).reshape(-1) for n in NAMES] if with_dw else []
    parts += [dls[n] for n in NAMES] + [db[n] for n in NAMES]
    return torch.cat(parts)


# --- the backward with dW in two passes (csrc/mlp_train_dw.cu) ---------------
def train_workspaces_plain(params, params_t, ls, pts, dirs, g,
                           bf16: bool = False):
    """(ws, du): the forward's workspace of u and the first pass's du
    workspace as the kernels leave them for the weight gradient's GEMM,
    (ceil(N / 64) * 64, U_SIZE) each, from the plain chain (in bf16 its
    bf16 form; du then holds bf16 values). Rows past N are those of zero
    points with a zero cotangent: their du is zero."""
    n = pts.shape[0]
    pad = lambda t: F.pad(t, (0, 0, 0, _padded(n) - n))
    ws = pts.new_zeros((_padded(n), U_SIZE))
    du = torch.zeros_like(ws)
    if bf16:
        params, params_t = round_weights_bf16(params, params_t)
    mlp_train_bwd_plain(params, params_t, ls, pad(pts), pad(dirs), pad(g),
                        False, rnd=bf16_round if bf16 else None,
                        workspaces=(ws, du))
    return ws, du


def mlp_train_dw_plain(ws, du, ls, biases, pts, dirs, bf16: bool = False,
                       chunk: int = DW_CHUNK):
    """Plain version of the weight gradient's GEMM: every layer's dW (out,
    in), flat in the WT_OFFSETS layout, from the workspaces of u and du
    (:func:`train_workspaces_plain`, or the kernels'), with the GEMM's
    arithmetic: X rebuilt as act(u * ls + b) of the layer below (rounded to
    bf16 in bf16) or the positional encoding of the points, dU^T X summed
    over blocks of DW_BLOCK points, each block's sum started from zero and
    added to its chunk's partial, the chunks' partials added in chunk order,
    dW rounded to bf16 once summed in bf16."""
    n = pts.shape[0]
    rows = _padded(n)
    q = bf16_round if bf16 else (lambda t: t)
    pad = lambda t: F.pad(t, (0, 0, 0, rows - n))
    pe = q(positional_encoding(pad(pts), 10))
    ve = q(positional_encoding(pad(dirs), 4))
    col = dict(zip(NAMES, U_OFFSETS))
    dims = dict(_DIMS)

    def h(name):
        c, w = col[name], dims[name][1]
        u = ws[:rows, c:c + w] * ls[c:c + w] + biases[c:c + w]
        return q(u if name == "feature_linear" else F.relu(u))

    inputs = {"pts_linears.0": pe, "pts_linears.5": torch.cat(
        [pe, h("pts_linears.4")], -1), "feature_linear": h("pts_linears.7"),
        "alpha_linear": h("pts_linears.7"), "views_linears.0": torch.cat(
            [h("feature_linear"), ve], -1), "rgb_linear": h("views_linears.0")}
    for i in (1, 2, 3, 4, 6, 7):
        inputs[f"pts_linears.{i}"] = h(f"pts_linears.{i - 1}")
    out = []
    for name in NAMES:
        x, c = inputs[name], col[name]
        d = du[:rows, c:c + dims[name][1]]
        total = None
        for s in range(0, rows, chunk):
            xb = x[s:s + chunk].reshape(-1, DW_BLOCK, x.shape[1])
            db = d[s:s + chunk].reshape(-1, DW_BLOCK, d.shape[1])
            part = None
            for block in torch.bmm(db.transpose(1, 2), xb):
                part = block if part is None else part + block
            total = part if total is None else total + part
        out.append(q(total).reshape(-1))
    return torch.cat(out)


# ------------------------------------------------------------ the kernels
def _check_inputs(ls, pts, dirs, *more):
    n = pts.shape[0]
    _check("ls", ls, (U_SIZE,))
    _check("pts", pts, (n, 3))
    _check("dirs", dirs, (n, 3))
    if any(t.device != pts.device for t in (ls, dirs, *more)):
        raise ValueError("the weights, ls, pts and dirs must be on one device")
    if pts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {pts.device}")
    return n


def _kernel_buffer(name, buf, size, made_from, make, dtype=torch.float32):
    """A packed weight buffer a tensor-core kernel launches with: ``buf``
    checked (the kernels copy it 16 bytes at a time), or, if None, made by
    ``make`` from the :func:`pack_train` buffer ``made_from``."""
    if buf is None:
        if made_from is None:
            raise ValueError(f"{name}: neither it nor the buffer it is made "
                             "from was given")
        buf = make(made_from)
    _check(name, buf, (size,), dtype)
    if buf.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    return buf


def _biases(biases, params):
    if biases is None:
        biases = gather_biases(params)
    _check("biases", biases, (U_SIZE,))
    return biases


# float32 / bf16: (kernel names, plain versions, forward buffer: name, size,
# made from params by, dtype; backward buffer: the same from params_t;
# the forward's tile; the du workspace's type)
_FORMS = {
    False: dict(fwd="mlp_train_fwd", bwd="mlp_train_bwd",
                bwd_dw="mlp_train_bwd_dw", c_bwd="nnc_mlp_train_bwd_mma",
                c_dw="nnc_mlp_train_dw", du=(torch.float32, U_SIZE),
                fwd_plain=mlp_train_fwd_plain, bwd_plain=mlp_train_bwd_plain,
                buf=("packed_wg", FWD_WG_SIZE, repack_wgmma, torch.float32),
                buf_t=("packed_wg_t", BWD_WG_SIZE, repack_wgmma_t,
                       torch.float32), tile=TILE),
    True: dict(fwd="mlp_train_fwd_bf16", bwd="mlp_train_bwd_bf16",
               bwd_dw="mlp_train_bwd_dw_bf16", c_bwd="nnc_mlp_train_bwd_bf16",
               c_dw="nnc_mlp_train_dw_bf16",
               du=(torch.bfloat16, DU_COLS_BF16),
               fwd_plain=mlp_train_fwd_bf16_plain,
               bwd_plain=mlp_train_bwd_bf16_plain,
               buf=("packed_bf16", BF16_PARAMS_SIZE, repack_bf16, torch.int32),
               buf_t=("packed_bf16_t", BWD_BF16_PARAMS_SIZE, repack_bf16_t,
                      torch.int32), tile=TILE_BF16),
}


def _fwd(bf16, params, ls, pts, dirs, save_u, packed, biases):
    form = _FORMS[bf16]
    given = [t for t in (params, packed, biases) if t is not None]
    n = _check_inputs(ls, pts, dirs, *given)
    if params is not None:
        _check("params", params, (PARAMS_SIZE,))
    if pts.device.type == "cpu":
        if params is None:
            raise ValueError("the plain version reads params")
        return form["fwd_plain"](params, ls, pts, dirs), None
    name, size, make, dtype = form["buf"]
    packed = _kernel_buffer(name, packed, size, params, make, dtype)
    biases = _biases(biases, params)
    lib = _build.lib()
    out = torch.empty((n, 4), dtype=torch.float32, device=pts.device)
    ws = torch.empty((_padded(n, form["tile"]), U_SIZE), dtype=torch.float32,
                     device=pts.device) if save_u else None
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.count_launch(form["fwd"])
        _build.check(getattr(lib, "nnc_" + form["fwd"])(
            packed.data_ptr(), ls.data_ptr(), biases.data_ptr(),
            pts.data_ptr(), dirs.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), n, stream), form["fwd"])
    return out, ws


def mlp_train_fwd(params, ls, pts, dirs, save_u: bool = False,
                  packed_wg=None, biases=None):
    """K-B1 forward wrapper: (raw (N, 4), workspace). With ``save_u`` the
    kernel also writes every layer's u per point, (ceil(N / 64) * 64,
    U_SIZE), for :func:`mlp_train_bwd`; else the workspace is None.

    CUDA tensors launch the kernel, which reads ``packed_wg`` (the forward
    buffer of :func:`pack_train_wgmma`) and ``biases`` (U_SIZE,); each is made
    from ``params`` here if not given, and ``params`` may be None if both
    are. CPU tensors take the plain version on ``params`` (no workspace)."""
    return _fwd(False, params, ls, pts, dirs, save_u, packed_wg, biases)


def mlp_train_fwd_bf16(params, ls, pts, dirs, save_u: bool = False,
                       packed_bf16=None, biases=None):
    """K-B1 forward wrapper in bf16: :func:`mlp_train_fwd` with the bf16
    kernel, which reads ``packed_bf16`` (the forward buffer of
    :func:`pack_train_bf16`, made from ``params`` if not given); its
    workspace has ceil(N / 128) * 128 rows. CPU tensors take
    :func:`mlp_train_fwd_bf16_plain`."""
    return _fwd(True, params, ls, pts, dirs, save_u, packed_bf16, biases)


def _bwd(bf16, params, params_t, ls, pts, dirs, g, ws, with_dw, packed_t,
         biases, du=None):
    form = _FORMS[bf16]
    given = [t for t in (params, params_t, packed_t, biases, g, du)
             if t is not None]
    n = _check_inputs(ls, pts, dirs, *given)
    if params is not None:
        _check("params", params, (PARAMS_SIZE,))
    if params_t is not None:
        _check("params_t", params_t, (WT_SIZE,))
    _check("g", g, (n, 4))
    if pts.device.type == "cpu":
        if params is None or params_t is None:
            raise ValueError("the plain version reads params and params_t")
        return form["bwd_plain"](params, params_t, ls, pts, dirs, g, with_dw)
    if ws is None:
        raise ValueError("the CUDA backward needs the forward's workspace "
                         f"({form['fwd']}(save_u=True))")
    _check("ws", ws, (_padded(n, form["tile"]), U_SIZE))
    if with_dw:
        du_dtype, du_cols = form["du"]
        if du is None:
            du = torch.empty((ws.shape[0], du_cols), dtype=du_dtype,
                             device=pts.device)
        _check("du", du, (ws.shape[0], du_cols), du_dtype)
    elif du is not None:
        raise ValueError("the du workspace is for the backward with dW")
    name, size, make, dtype = form["buf_t"]
    packed_t = _kernel_buffer(name, packed_t, size, params_t, make, dtype)
    biases = _biases(biases, params)
    lib = _build.lib()
    sms = torch.cuda.get_device_properties(pts.device).multi_processor_count
    grid = min(_padded(n) // TILE, sms)
    chunks = -(-_padded(n) // DW_CHUNK)
    dw_size = WT_SIZE if with_dw else 0
    partials = torch.empty((max(grid * 2 * U_SIZE,
                                chunks * dw_size if n else 0),),
                           dtype=torch.float32, device=pts.device)
    out = torch.empty((grad_size(with_dw),), dtype=torch.float32,
                      device=pts.device)
    kernel = form["bwd_dw" if with_dw else "bwd"]
    with torch.cuda.device(pts.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.count_launch(kernel)
        # the tensor-core backward: dls and db (and every du with dW)
        _build.check(getattr(lib, form["c_bwd"])(
            packed_t.data_ptr(), ls.data_ptr(), biases.data_ptr(),
            g.data_ptr(), ws.data_ptr(), None if du is None else du.data_ptr(),
            partials.data_ptr(), out[dw_size:].data_ptr(), n, grid, stream),
            kernel)
        if with_dw:
            # the weight gradient's GEMM over the two workspaces
            _build.check(getattr(lib, form["c_dw"])(
                ws.data_ptr(), du.data_ptr(), ls.data_ptr(),
                biases.data_ptr(), pts.data_ptr(), dirs.data_ptr(),
                partials.data_ptr(), out.data_ptr(), n, DW_CHUNK, stream),
                kernel)
    return out


def mlp_train_bwd(params, params_t, ls, pts, dirs, g, ws, with_dw: bool,
                  packed_wg_t=None, biases=None, du=None):
    """K-B1 backward wrapper: the flat gradient [dW (with_dw), dls, db] for
    the raw cotangent ``g`` (N, 4). CUDA tensors need the forward's
    workspace ``ws``; CPU tensors take the plain version.

    On CUDA tensors the tensor-core kernel reads ``packed_wg_t`` (the
    backward buffer of :func:`pack_train_wgmma`) and ``biases`` (U_SIZE,),
    made here from ``params_t`` and ``params`` if not given (each of which
    may be None if its buffer is). With dW it also writes every layer's du
    to a workspace of ``ws``'s shape (``du``, made here if not given), from
    which, with ``ws``, the weight gradient's GEMM (csrc/mlp_train_dw.cu)
    sums dW; rows past the first pass's whole 64-point tiles are neither
    written nor read."""
    return _bwd(False, params, params_t, ls, pts, dirs, g, ws, with_dw,
                packed_wg_t, biases, du)


def mlp_train_bwd_bf16(params, params_t, ls, pts, dirs, g, ws, with_dw: bool,
                       packed_bf16_t=None, biases=None, du=None):
    """K-B1 backward wrapper in bf16: :func:`mlp_train_bwd` with the bf16
    kernels, on the workspace of :func:`mlp_train_fwd_bf16`; the tensor-core
    kernel reads ``packed_bf16_t`` (the backward buffer of
    :func:`pack_train_bf16`) and ``biases``, and with dW writes every
    layer's bf16(du) to a bf16 workspace ``du`` (``ws``'s rows, DU_COLS_BF16
    columns) for the GEMM, which rounds dW once summed. CPU tensors take
    :func:`mlp_train_bwd_bf16_plain`."""
    return _bwd(True, params, params_t, ls, pts, dirs, g, ws, with_dw,
                packed_bf16_t, biases, du)


class _TrainMLP(torch.autograd.Function):
    """raw = MLP(pts, dirs) over the flat per-layer (weight, bias, scales),
    in the float32 or (``bf16``) the bf16 form. ``packs``: the weights'
    :data:`TRAIN_PACKS` entry for CUDA tensors (the kernels then need no
    other packing of them), None for CPU tensors, which pack for the plain
    versions."""

    @staticmethod
    def forward(ctx, pts, dirs, with_dw, bf16, packs, *tensors):
        weights, biases, scales = tensors[0::3], tensors[1::3], tensors[2::3]
        params = params_t = b = None
        if packs is None:
            params, params_t, ls = pack_train(weights, biases, scales)
        if packs is not None:
            ls = torch.cat([t.reshape(-1).float() for t in scales])
            b = torch.cat([t.float() for t in biases])
        raw, ws = _fwd(bf16, params, ls, pts, dirs, packs is not None,
                       packs and packs[0], b)
        ctx.with_dw, ctx.bf16 = with_dw, bf16
        ctx.scale_shapes = [t.shape for t in scales]
        ctx.buffers = (params, params_t, b, packs and packs[1], ws)
        ctx.save_for_backward(pts, dirs, ls, *weights)
        return raw

    @staticmethod
    def backward(ctx, g):
        pts, dirs, ls, *weights = ctx.saved_tensors
        params, params_t, b, packed_t, ws = ctx.buffers
        flat = _bwd(ctx.bf16, params, params_t, ls, pts, dirs,
                    g.float().contiguous(), ws, ctx.with_dw, packed_t, b)
        dW, dls, db = split_grads(flat, ctx.with_dw)
        need = ctx.needs_input_grad[5:]
        grads = []
        for i, name in enumerate(NAMES):
            gw = dW[name] if dW is not None else torch.zeros_like(weights[i])
            grads += [gw if need[3 * i] else None,
                      db[name] if need[3 * i + 1] else None,
                      dls[name].reshape(ctx.scale_shapes[i])
                      if need[3 * i + 2] else None]
        return (None, None, None, None, None, *grads)


def fused_nerf_mlp_train(model: nerf.NeRF, pts, viewdirs,
                         with_dw: bool = False):
    """Differentiable posenc + MLP from raw points (training renders).

    pts: (..., 3); viewdirs broadcastable to pts. Returns raw (..., 4)
    float32, with gradients for every layer's ``weight_scaling`` and
    ``bias``, and for ``weight`` only ``with_dw``. ``model.config.
    compute_dtype`` picks the float32 or the bf16 form (mlp_train_pallas.py:
    380); non-flagship configurations take the plain MLP (output-scaling
    form in float32; in bf16 the reference's one plain form, the scale
    folded before the rounding). On CUDA tensors the weights'
    fragment-ordered buffers come from :data:`TRAIN_PACKS`."""
    vd = torch.broadcast_to(viewdirs, pts.shape)
    if not supports(model.config):
        return nerf.apply_mlp(model, positional_encoding(pts, 10),
                              positional_encoding(vd, 4), output_scaling=True)
    dtype = model.config.compute_dtype
    lead = pts.shape[:-1]
    tensors = _layer_tensors(model)
    packs = TRAIN_PACKS.get(tensors[0::3], dtype) if pts.is_cuda else None
    raw = _TrainMLP.apply(pts.detach().reshape(-1, 3).float().contiguous(),
                          vd.detach().reshape(-1, 3).float().contiguous(),
                          with_dw, dtype == torch.bfloat16, packs, *tensors)
    return raw.reshape(*lead, 4)
